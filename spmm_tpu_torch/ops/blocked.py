"""SpMM over the preprocessed BlockedCSR format (port of
``spmm_tpu/ops/blocked.py``).

The consumer the reference's packed format implies (SURVEY.md §3.3): rows in
final (bitmap ∘ panel-sort) order, v8 groups stored 8-row interleaved, column
ids relabeled per region against a compacted RHS panel (``gather_cols``),
rows un-permuted with ``row_inv`` at the end.

- ``blocked_spmm_slab`` — the production path and the driver's single-chip
  forward (``entry.py``).  Each bucket of equal-length v8 groups is one
  (8G, L) slab, and kernel K2 (``ops/ell_kernel.py``) takes all of them in
  one launch, each into its row range of one output; the leftover rows are
  a gather + ``index_add_`` stream; one ``index_select`` un-permutes.
- ``blocked_spmm_xla`` / ``blocked_spmm_panel`` — per-nonzero gather +
  ``index_add_`` formulations (single gather from B; two-stage gather through
  the compacted panel).
- ``blocked_chain_spmv`` — y = A^iters x through the self-referential
  ``gather_rows`` map (the reference's ``seq_input`` contract).

Every view lies on the device of P's leaves (the CPU for numpy leaves) and is
built once for many multiplies.  Every product sums and returns in
``accum_dtype`` (fp32 by default, as in the JAX package; ``torch.float64``
runs on K2 on the card when the packed values and B are fp64).  Gradients
flow to B through every formulation, and to the view's bucket values through
the slab path (``ops/ell_kernel.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_tpu_torch.formats.containers import BlockedCSR, as_numpy, as_tensor, device_of
from spmm_tpu_torch.ops.ell_kernel import (
    ell_slabs_spmm_into,
    ell_slabs_spmm_reference,
    table_memo,
)
from spmm_tpu_torch.ops.segments import boundary_segments


def _final_out_rows(P: BlockedCSR, device) -> torch.Tensor:
    """Per packed nonzero: the (final-order) output row it contributes to.

    Remain rows: the CSR row containing the position.  v8 groups are 8-row
    interleaved, so position ``group_nnz[g] + t`` belongs to group-row
    ``t % 8`` (reference layout, serial_newblock_clock.cpp:366-385)."""
    nnz_pad = P.data.shape[0]
    r0 = boundary_segments(P.indptr, nnz_pad, dtype=torch.int64, device=device)
    if P.ngroups == 0:
        return r0
    g = as_tensor(P.row_group, device).long()[r0]
    gsafe = g.clamp(0, P.ngroups - 1)
    off = torch.arange(nnz_pad, device=device) - as_tensor(P.group_nnz, device).long()[gsafe]
    grow = as_tensor(P.group_row, device).long()[gsafe] + off % 8
    return torch.where(g >= 0, grow, r0)


def _panel_slots(P: BlockedCSR, device) -> torch.Tensor:
    """Per packed nonzero: its slot in the region-concatenated relabel space
    (``region_gather[region] + cols_local``, the compacted-panel index the
    reference's relabel pass exists to produce, SURVEY.md §2.7)."""
    nnz_pad = P.data.shape[0]
    reg = boundary_segments(P.region_nnz, nnz_pad, dtype=torch.int64, device=device)
    slot = as_tensor(P.region_gather, device).long()[reg] + as_tensor(P.cols_local, device).long()
    return slot.clamp(0, max(P.ndistinct - 1, 0))


def _global_cols(P: BlockedCSR, device) -> torch.Tensor:
    """Undo the per-region relabel: original column id per packed nonzero."""
    return as_tensor(P.gather_cols, device)[_panel_slots(P, device)]


def blocked_exec_view(P: BlockedCSR):
    """Pack-once execution view ``(out_rows, global_cols)`` per packed
    nonzero, on P's device, reused across multiplies."""
    dev = device_of(P.data)
    return _final_out_rows(P, dev), _global_cols(P, dev)


def _segment_product(P: BlockedCSR, src: torch.Tensor, cols, out_rows, permute_back: bool, acc):
    dev = src.device
    contrib = src.index_select(0, cols.to(dev)).to(acc) * as_tensor(P.data, dev).to(acc)[:, None]
    y = torch.zeros((P.nrow, src.shape[1]), dtype=acc, device=dev)
    y.index_add_(0, out_rows.to(dev), contrib)  # padding: data == 0 contributes nothing
    if not permute_back:
        return y
    return y.index_select(0, as_tensor(P.row_inv, dev).long())


def blocked_spmm_xla(P: BlockedCSR, B: torch.Tensor, *, permute_back: bool = True, view=None,
                     accum_dtype=torch.float32):
    """Y = unpack(P) @ B in ``accum_dtype`` via the packed stream: one gather from B per
    packed nonzero and an ``index_add_`` into final-order rows (validates the
    whole format: interleave, relabel, permutations).  Pass
    ``view=blocked_exec_view(P)`` to pack once and multiply many times."""
    dev = B.device
    out_rows, gcols = view if view is not None else (_final_out_rows(P, dev), _global_cols(P, dev))
    return _segment_product(P, B, gcols, out_rows, permute_back, accum_dtype)


def blocked_panel_view(P: BlockedCSR):
    """Pack-once view for the two-stage panel SpMM: ``(out_rows, slots,
    gather_cols)``; ``slots`` index the region-concatenated compacted panel
    instead of the full B (reference serial_newblock_clock.cpp:187-204)."""
    dev = device_of(P.data)
    return _final_out_rows(P, dev), _panel_slots(P, dev), as_tensor(P.gather_cols, dev)


def blocked_spmm_panel(P: BlockedCSR, B: torch.Tensor, *, permute_back: bool = True, view=None,
                       accum_dtype=torch.float32):
    """Y = unpack(P) @ B via the two-stage region-panel gather: stage 1
    compacts the referenced B rows once (``B[gather_cols]``), stage 2 gathers
    each packed nonzero's row from the compacted panel by relabeled slot."""
    dev = B.device
    out_rows, slots, gcols = (
        view if view is not None
        else (_final_out_rows(P, dev), _panel_slots(P, dev), as_tensor(P.gather_cols, dev))
    )
    panel = B.index_select(0, gcols.to(dev))  # stage 1
    return _segment_product(P, panel, slots, out_rows, permute_back, accum_dtype)


def blocked_slab_view(P: BlockedCSR, *, panel: bool = False):
    """Pack-once v8-slab execution view, on P's device.  The 8-row interleave
    (slot ``base + 8e + r`` holds element e of group-row r) makes each group
    a dense (8, L) tile, so the G groups of one length L form one (8G, L)
    slab in K2's layout: row ``8g + r`` is group g's row r.  Leftover rows
    (not in a group, empty ones included) become a sorted gather +
    ``index_add_`` stream; one precomputed gather un-permutes the
    concatenated parts to original row order.

    Returns a :class:`SlabView` ``(buckets, rem, order_map)``:
      buckets: tuple of (data (8G, L), cols (8G, L) int32), both contiguous;
      rem: (cols int32, vals, seg int32) for the leftover rows;
      order_map: (nrow,) int32 concat position of each ORIGINAL row.

    ``panel=True``: the column ids are relabeled PANEL SLOTS instead of
    global ids and the view carries ``gather_cols`` as a 4th element; the
    multiply then stages the compacted panel first."""
    dev = device_of(P.data)
    host = lambda a: np.asarray(as_numpy(a), np.int64)  # nrow- and ngroups-scale only
    h_gl, h_gn, h_grow, h_rg = (host(a) for a in (P.group_len, P.group_nnz, P.group_row, P.row_group))
    nrow = P.nrow

    # (nnz_pad,) per packed nonzero, computed once: panel slots or global ids
    cols_full = _panel_slots(P, dev) if panel else _global_cols(P, dev)
    cols_full = cols_full.to(torch.int32)
    data_full = as_tensor(P.data, dev)

    buckets, bucket_rows = [], []
    order_map_final = np.empty(nrow, np.int64)
    off = 0
    for L in np.unique(h_gl):
        L = int(L)
        ids = np.nonzero(h_gl == L)[0]
        G = len(ids)
        # position of (group g, row r, element e): group_nnz[g] + 8e + r
        tile = torch.arange(8, device=dev)[:, None] + 8 * torch.arange(L, device=dev)[None, :]
        pos = (as_tensor(h_gn[ids], dev)[:, None, None] + tile[None]).reshape(-1)
        buckets.append((data_full[pos].reshape(8 * G, L), cols_full[pos].reshape(8 * G, L)))
        rows8 = h_grow[ids][:, None] + np.arange(8)[None, :]  # (G, 8)
        order_map_final[rows8.reshape(-1)] = off + np.arange(G * 8)
        bucket_rows.append(rows8.reshape(-1))
        off += G * 8

    # non-group rows (empty ones included): sorted stream, segment id = rank
    nongroup = np.nonzero(h_rg < 0)[0]
    rank = np.full(nrow, -1, np.int64)
    rank[nongroup] = np.arange(len(nongroup))
    order_map_final[nongroup] = off + rank[nongroup]
    row_of_pos = boundary_segments(P.indptr, P.nnz, dtype=torch.int64, device=dev)
    rem_pos = torch.nonzero(as_tensor(h_rg, dev)[row_of_pos] < 0).flatten()
    rem = (
        cols_full[rem_pos],
        data_full[rem_pos],
        as_tensor(rank, dev)[row_of_pos[rem_pos]].to(torch.int32),
    )
    # original row i sits at final position row_inv[i], whose concat slot is
    # order_map_final[row_inv[i]]
    order_map = as_tensor(order_map_final[host(P.row_inv)].astype(np.int32), dev)
    out = (tuple(buckets), rem, order_map)
    if panel:
        out = out + (as_tensor(P.gather_cols, dev),)
    view = SlabView(out)
    view.row_keys = np.concatenate(bucket_rows) if bucket_rows else np.zeros(0, np.int64)
    return view


class SlabView(tuple):
    """The tuple :func:`blocked_slab_view` returns.  Unlike a plain tuple it
    carries ``row_keys``, the final-order row of each bucket row (K2 runs
    its work in that order, which the preprocessing made local), and the
    memo of K2's work table over its buckets."""


def _slab_product(B: torch.Tensor, view, plain: bool, acc) -> torch.Tensor:
    """The slab view times B: every bucket through K2 in one call (its plain
    version when ``plain``), the leftover stream through ``index_add_``."""
    if len(view) == 4:
        buckets, rem, order_map, gcols = view
        B = B.index_select(0, gcols)  # stage 1: compacted panel
    else:
        buckets, rem, order_map = view
    y = torch.empty((order_map.shape[0], B.shape[1]), dtype=acc, device=B.device)
    data = tuple(d for d, _ in buckets)
    cols = tuple(c for _, c in buckets)
    off = sum(int(c.shape[0]) for c in cols)
    if plain:
        ell_slabs_spmm_reference(cols, data, B, y[:off], accum_dtype=acc)
    elif buckets:
        ell_slabs_spmm_into(y, 0, cols, data, B, memo=table_memo(view),
                            row_keys=getattr(view, "row_keys", None), accum_dtype=acc)
    cols, vals, seg = rem
    contrib = B.index_select(0, cols).to(acc) * vals.to(acc)[:, None]
    y[off:].zero_().index_add_(0, seg, contrib)
    return y.index_select(0, order_map)


def blocked_spmm_slab(P: BlockedCSR, B: torch.Tensor, view, *,
                      accum_dtype=torch.float32) -> torch.Tensor:
    """Y = unpack(P) @ B in ``accum_dtype`` via the v8-slab view (pack once,
    multiply many): one K2 launch over all buckets (its plain version for CPU
    tensors), the leftover stream through ``index_add_``.  Rows return in
    ORIGINAL order.  A 4-element (panel) view stages the compacted RHS panel
    once and every bucket reads it by relabeled slot."""
    return _slab_product(B, view, plain=False, acc=accum_dtype)


def blocked_spmm_slab_reference(P: BlockedCSR, B: torch.Tensor, view, *,
                                accum_dtype=torch.float32) -> torch.Tensor:
    """:func:`blocked_spmm_slab` with K2's plain version on every bucket, on
    any device: what the kernel path is held against on the card."""
    return _slab_product(B, view, plain=True, acc=accum_dtype)


def blocked_chain_spmv(P: BlockedCSR, x: torch.Tensor, iters: int, *,
                       accum_dtype=torch.float32) -> torch.Tensor:
    """y = A^iters @ x on a SQUARE matrix through the self-referential gather
    map, the runtime contract the reference's ``seq_input`` exists for
    (reference wbsort.h:81-95, SURVEY.md §2.8/§3.3): relabeled column ``j``
    of region ``r`` reads the iterate at FINAL position
    ``gather_rows[region_gather[r] + j]``, so chained products never leave
    the permuted order; the permutations apply once at entry (``row_perm``)
    and once at exit (``row_inv``).  Sums and returns in ``accum_dtype``."""
    if P.shape[0] != P.shape[1]:
        raise ValueError("seq_input chaining is defined for square matrices only")
    dev = x.device
    out_rows = _final_out_rows(P, dev)
    # the per-region panel gather composed with the slot gather: one index
    src = as_tensor(P.gather_rows, dev).long()[_panel_slots(P, dev)]
    vals = as_tensor(P.data, dev).to(accum_dtype)
    y = x.to(accum_dtype).index_select(0, as_tensor(P.row_perm, dev).long())  # to final order
    for _ in range(iters):
        y = torch.zeros(P.nrow, dtype=accum_dtype, device=dev).index_add_(
            0, out_rows, vals * y.index_select(0, src)
        )
    return y.index_select(0, as_tensor(P.row_inv, dev).long())  # back to original order


def blocked_spmm(P: BlockedCSR, B: torch.Tensor, *, view=None,
                 accum_dtype=torch.float32) -> torch.Tensor:
    """Dispatcher for the packed-format SpMM: the v8-slab path.  ``view``: a
    :func:`blocked_slab_view` built once for repeated multiplies; one-shot
    calls build it here, on B's device."""
    if view is None:
        view = blocked_slab_view(P.to(B.device))
    return blocked_spmm_slab(P, B, view, accum_dtype=accum_dtype)
