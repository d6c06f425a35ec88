"""Row-partitioned SpGEMM over a ``DeviceMesh`` (port of
``spmm_tpu/parallel/spgemm_spmd.py``).

The left matrix is row-block sharded over the mesh's "rows" axis (the
reference's region split is the shard unit, SURVEY.md §2.4/§2.12).  Every
shard runs the same slab program (``ops/slab_spgemm.py``) with one chunk
schedule: the pa padding is the maximum over shards, the schedule is built
from the per-class maximum row counts, and each shard gets its own (start,
count) per chunk (an empty chunk only masks).  Every rank sizes all shards
on the host, so all ranks hold the same schedule without a collective; each
then runs only its own shard through the piece executor the streamed big
path uses (``_piece_exec`` / ``_piece_csr``), and its heavy-tail rows
through the global-sort ESC.  The collectives assemble the result, and
fetch B's rows where B is sharded.  The B strategies:

- :func:`spgemm_dist_spmd` / :func:`spgemm_dist_csr` — B replicated;
- :func:`spgemm_dist_halo` — each rank holds only the B rows its shard's
  column ids reference (the halo set, SURVEY.md §2.12), built on the host;
- :func:`spgemm_dist_halo_exchange` — B row-block sharded, each rank's halo
  fetched from the owners of its rows by one ``all_to_all_single`` with
  exact split sizes;
- :func:`spgemm_dist_plan` / :func:`spgemm_dist_exec` /
  :func:`spgemm_dist_revalue` — plan once (B replicated or, with
  ``b_sharded``, exchanged at plan time only), multiply many;
- :func:`spgemm_dist_big` — the streamed big path over the mesh.

Every rank calls an entry point with the same host ``ShardedCSR`` (or CSR)
and host B, and every rank returns the same global host CSR, as the JAX
package's single controller does.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from spmm_tpu_torch import native
from spmm_tpu_torch.formats.containers import CSR, as_tensor
from spmm_tpu_torch.ops.slab_kernel import check_class_limit, chunk_fetch_all, compact_to_csr, slab_merge_all
from spmm_tpu_torch.ops.slab_spgemm import (
    DEFAULT_CLASSES,
    DEFAULT_SEG_W,
    DEFAULT_SLOT_BUDGET,
    _BigCheckpoint,
    _bucket_pow2,
    _choose_pieces,
    _dtype_name,
    _is_pattern,
    _local_csr,
    _norm_classes,
    _piece_csr,
    _piece_exec,
    _piece_kw,
    _plan_tables,
    _round_up,
    _stable_argsort_smallint,
    _stitch,
    _tail_pairs,
    _tail_products,
)
from spmm_tpu_torch.parallel.mesh import axis_size, check_on_mesh, mesh_device
from spmm_tpu_torch.parallel.partition import ShardedCSR, local_shard, rows_per_shard


def _per_shard_sizing(S: ShardedCSR, B: CSR | None, W: int, classes, b_iptr_per_shard=None):
    """Host sizing of each shard against one B: (cls (nsh, rows_pad) int32,
    counts (nsh, nclasses + 1) int64, npa_max, nnz (nsh,) int32, npa_body
    (nsh,) int64).  ``b_iptr_per_shard``: each shard's own local B indptr
    (the halo paths; ``B`` is then not read), else one B for all.
    ``npa_body`` counts only the pairs of rows below the class ceiling: a
    tail row goes to the global-sort ESC, so its pairs take no slab slots.
    Raises ValueError when a shard's padded expansion exceeds the int32
    range."""
    b_iptr_rep = None if b_iptr_per_shard is not None else np.asarray(B.host().indptr, np.int64)
    ind = np.asarray(S.indices)
    iptr = np.asarray(S.indptr, dtype=np.int64)
    classes_np = np.asarray(classes, np.int64)
    tail = len(classes)
    cls_all, counts_all, npa_max, nnz_s, body = [], [], 0, [], []
    for s in range(S.n_shards):
        b_iptr = b_iptr_rep if b_iptr_rep is not None else np.asarray(b_iptr_per_shard[s], np.int64)
        nsegB_row = (b_iptr[1:] - b_iptr[:-1] + W - 1) // W
        nnz = int(iptr[s, -1])
        nnz_s.append(nnz)
        res = native.spgemm_sizing(iptr[s], ind[s, :nnz], b_iptr, W, classes_np)
        if res is not None:
            npa, _, cls = res
        else:
            nseg = nsegB_row[ind[s, :nnz].astype(np.int64)]
            npa = int(nseg.sum())
            segc = np.zeros(nnz + 1, dtype=np.int64)
            np.cumsum(nseg, out=segc[1:])
            exp_pad = W * (segc[iptr[s, 1:]] - segc[iptr[s, :-1]])
            cls = np.searchsorted(classes_np, exp_pad, side="left").astype(np.int32)
            cls[exp_pad == 0] = len(classes) + 1
        if npa * W >= 2**31:
            raise ValueError(
                f"shard {s}: padded expansion exceeds int32 range; "
                "use more shards or chunk rows first"
            )
        npa_max = max(npa_max, npa)
        body.append(npa - _tail_pairs(iptr[s], ind[s], cls, tail, nsegB_row))
        counts_all.append(np.bincount(cls, minlength=len(classes) + 2)[: len(classes) + 1])
        cls_all.append(cls)
    return (
        np.stack(cls_all),
        np.stack(counts_all).astype(np.int64),
        npa_max,
        np.asarray(nnz_s, np.int32),
        np.asarray(body, np.int64),
    )


def _uniform_schedule(classes, counts, slot_budget):
    """Chunk schedule ``[(L, R_pad), ...]`` covering the per-class maximum
    count over shards, per-shard (start, count) tables (nsh, nchunks) int32,
    and each shard's offset of its tail rows in its class order."""
    nsh = counts.shape[0]
    max_counts = counts.max(axis=0)
    offsets = np.concatenate([np.zeros((nsh, 1), np.int64), np.cumsum(counts, axis=1)], axis=1)
    sched, starts, cnts = [], [], []
    for ci, L in enumerate(classes):
        n = int(max_counts[ci])
        rows_per_chunk = max(slot_budget // L, 8)
        for lo in range(0, n, rows_per_chunk):
            cap = min(rows_per_chunk, n - lo)
            R_pad = min(_bucket_pow2(cap), _round_up(cap, 1 << 10))
            sched.append((L, R_pad))
            starts.append(offsets[:, ci] + lo)
            cnts.append(np.clip(counts[:, ci] - lo, 0, rows_per_chunk))
    starts = np.stack(starts, axis=1).astype(np.int32) if sched else np.zeros((nsh, 0), np.int32)
    cnts = np.stack(cnts, axis=1).astype(np.int32) if sched else np.zeros((nsh, 0), np.int32)
    return sched, starts, cnts, offsets[:, len(classes)].astype(np.int64)


def _detect_shard_pattern(S: ShardedCSR, B: CSR) -> bool:
    """All-ones values over host shards (device-held shards are never pulled
    to the host for it: see ``ops.slab_spgemm._is_pattern``)."""
    if not isinstance(S.data, np.ndarray):
        return False
    siptr = np.asarray(S.indptr, np.int64)
    return _is_pattern(B) and all(
        bool(np.all(S.data[s, : int(siptr[s, -1])] == 1)) for s in range(S.n_shards)
    )


def _host_b(B: CSR, mesh: DeviceMesh) -> CSR:
    """B on the host; a B held in tensors must lie on the mesh's device type
    (it is not copied across silently)."""
    if isinstance(B.data, torch.Tensor):
        check_on_mesh(mesh, B.data, "B")
    return B.host()


# ---------------------------------------------------------------------------
# the halo: the B rows each shard references
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Halo:
    """Every shard's halo (SURVEY.md §2.12): ``rows[s]`` the sorted unique
    column ids of shard s, that is the B rows it references (int64);
    ``rel`` A's indices relabeled to positions in ``rows`` ((nsh, nnz_pad),
    the dtype of ``S.indices``, zero past each shard's nnz); ``iptr[s]`` the
    local B indptr of those rows (int64, len(rows[s]) + 1)."""

    rows: list
    rel: np.ndarray
    iptr: list


def _halo(S: ShardedCSR, b_iptr: np.ndarray) -> _Halo:
    """Host halo of every shard against a B of indptr ``b_iptr``: O(nnz(A) +
    shards · nrow(B)) (a mask over B's rows per shard, not a sort)."""
    ind = np.asarray(S.indices)
    iptr = np.asarray(S.indptr, np.int64)
    nrow_b = len(b_iptr) - 1
    rows_l, iptr_l = [], []
    rel = np.zeros_like(ind)
    for s in range(S.n_shards):
        cols = ind[s, : int(iptr[s, -1])]
        seen = np.zeros(nrow_b, bool)
        seen[cols] = True
        u = np.flatnonzero(seen)
        pos = torch.from_numpy(np.cumsum(seen, dtype=np.int32) - 1)
        rel[s, : len(cols)] = torch.index_select(pos, 0, torch.from_numpy(cols)).numpy()
        li = np.zeros(len(u) + 1, np.int64)
        np.cumsum(b_iptr[u + 1] - b_iptr[u], out=li[1:])
        rows_l.append(u.astype(np.int64))
        iptr_l.append(li)
    return _Halo(rows_l, rel, iptr_l)


def _rows_mask(nrow: int, rows: np.ndarray) -> np.ndarray:
    seen = np.zeros(nrow, bool)
    seen[rows] = True
    return seen


def _halo_b(Bh: CSR, rows: np.ndarray, loc_iptr: np.ndarray) -> CSR:
    """The host CSR of B's rows ``rows`` (ascending; B's columns stay
    global): a mask over B's elements, no index gather."""
    b_iptr = np.asarray(Bh.indptr, np.int64)
    keep = np.repeat(_rows_mask(len(b_iptr) - 1, rows), np.diff(b_iptr))
    nnz = int(b_iptr[-1])
    return CSR(data=np.asarray(Bh.data)[:nnz][keep],
               indices=np.asarray(Bh.indices, np.int32)[:nnz][keep],
               indptr=loc_iptr, shape=(len(rows), Bh.shape[1]), nnz=int(loc_iptr[-1]))


def partition_halo(S: ShardedCSR, B: CSR, *, structure_only: bool = False):
    """Per-shard halo restriction of B (SURVEY.md §2.12: the rows a shard's
    column ids reference are its halo set; the reference's distinct-column
    working set, transmat.h:334-376, is the same bound per region).

    For shard ``s``: ``halo_rows[s]`` = sorted unique column ids of A_s; B
    restricted to those rows, with A_s's indices relabeled to local halo
    positions (B's columns, the output space, stay global).  Returns the
    JAX package's ``(A_rel, b_indptr, b_ind, b_dat, halo_rows,
    halo_counts)``: A_rel a ShardedCSR with relabeled indices, the b_*
    arrays the per-shard local CSRs of B stacked (nsh, ...) and padded to
    the maximum over shards (empty rows, zero elements).  The ranks' own
    products take the unpadded halo (``_halo``); this layout is for
    comparison and inspection.

    ``structure_only=True`` skips the local B element arrays (``b_ind`` /
    ``b_dat`` return as (nsh, 1) placeholders): the runtime exchange fetches
    the elements from their owners."""
    Bh = B.host()
    b_iptr = np.asarray(Bh.indptr, np.int64)
    h = _halo(S, b_iptr)
    nsh = S.n_shards
    halo_counts = np.array([len(u) for u in h.rows], np.int64)
    nrow_loc = int(halo_counts.max()) if nsh else 1
    loc_iptr = np.zeros((nsh, nrow_loc + 1), np.int64)
    for s, li in enumerate(h.iptr):
        loc_iptr[s, : len(li)] = li
        loc_iptr[s, len(li) :] = li[-1]
    A_rel = dataclasses.replace(S, indices=h.rel)
    b_dat_g = np.asarray(Bh.data)[: B.nnz]
    if structure_only:
        ph = np.zeros((nsh, 1), np.int32)
        return A_rel, loc_iptr, ph, ph.astype(b_dat_g.dtype), h.rows, halo_counts
    nnzB_pad = max(int(loc_iptr[:, -1].max()), 1)
    loc_ind = np.zeros((nsh, nnzB_pad), np.int32)
    loc_dat = np.zeros((nsh, nnzB_pad), b_dat_g.dtype)
    for s in range(nsh):
        Bl = _halo_b(Bh, h.rows[s], h.iptr[s])
        loc_ind[s, : Bl.nnz] = Bl.indices
        loc_dat[s, : Bl.nnz] = Bl.data
    return A_rel, loc_iptr, loc_ind, loc_dat, h.rows, halo_counts


# ---------------------------------------------------------------------------
# the runtime halo exchange: B row-block sharded, halos fetched from owners
# ---------------------------------------------------------------------------


def _exchange_maps(halo_rows, b_iptr: np.ndarray, rb: int, owner: int):
    """Host maps of the runtime halo exchange over B row-block sharded in
    blocks of ``rb`` rows (``partition_rows(B, n)``; ``b_iptr`` is B's
    indptr), with exact split sizes (no per-pair padding): ``send`` (int32
    unless the block holds 2**31 elements or more), the flat indices into
    ``owner``'s block of the elements it sends, requester by requester,
    each in element order, and ``pair_nnz`` (n, n) int64, [s, t] the
    elements requester s receives from owner t.  Owners hold contiguous row
    blocks and each requester's halo rows ascend, so the blocks a requester
    receives, owner by owner, are its halo CSR's elements in order: no
    gather after the exchange."""
    nsh = len(halo_rows)
    lens = np.diff(b_iptr)
    lo, hi = (min(x * rb, len(lens)) for x in (owner, owner + 1))
    dt = np.int32 if b_iptr[hi] - b_iptr[lo] < 2**31 else np.int64
    pair_nnz = np.zeros((nsh, nsh), np.int64)
    send = [np.zeros(0, dt)]
    for s, u in enumerate(halo_rows):
        u = np.asarray(u, np.int64)
        pair_nnz[s] = np.bincount(u // rb, weights=lens[u], minlength=nsh)[:nsh].astype(np.int64)
        mine = u[np.searchsorted(u, lo) : np.searchsorted(u, hi)]
        ln = lens[mine]
        # each row's elements, b_iptr[r] - b_iptr[lo] onwards (O(sent), not O(block))
        first = (b_iptr[mine] - b_iptr[lo] - (np.cumsum(ln) - ln)).astype(dt)
        send.append(np.repeat(first, ln) + np.arange(int(ln.sum()), dtype=dt))
    return np.concatenate(send), pair_nnz


def _row_block(Bh: CSR, n: int, index: int, dev) -> CSR:
    """Block ``index`` of B row-block sharded over ``n`` ranks, on ``dev``:
    ``local_shard(partition_rows(B, n), index)`` without the copy of every
    block."""
    b_iptr = np.asarray(Bh.indptr, np.int64)
    rb = rows_per_shard(Bh.shape[0], n)
    lo, hi = (min(x * rb, Bh.shape[0]) for x in (index, index + 1))
    e0, e1 = int(b_iptr[lo]), int(b_iptr[hi])
    return CSR(data=as_tensor(np.asarray(Bh.data)[e0:e1], dev),
               indices=as_tensor(np.asarray(Bh.indices, np.int32)[e0:e1], dev),
               indptr=as_tensor(b_iptr[lo : hi + 1] - e0, dev), shape=(hi - lo, Bh.shape[1]),
               nnz=e1 - e0)


def _exchange_halo_body(block: CSR, send, pair_nnz, me: int, group, pattern: bool, *,
                        values_only: bool = False):
    """The runtime halo exchange on the mesh's device: this rank, as owner,
    sends the elements of its own B block that each requester asks for, and
    receives its halo's elements from their owners, by
    ``all_to_all_single`` with exact split sizes (NCCL on the card, gloo on
    the CPU).  Returns this rank's halo (indices, data).  In pattern mode
    only column ids travel and the values are ones; ``values_only`` sends
    only the values (a revalue keeps the indices) and returns (None,
    data)."""
    idx = torch.from_numpy(send).to(block.indices.device)
    ins, outs = pair_nnz[:, me].tolist(), pair_nnz[me, :].tolist()

    def swap(x):
        out = x.new_empty(sum(outs))
        dist.all_to_all_single(out, x.index_select(0, idx), output_split_sizes=outs,
                               input_split_sizes=ins, group=group)
        return out

    ind = None if values_only else swap(block.indices)
    if pattern:
        dat = torch.ones(sum(outs), dtype=block.data.dtype, device=block.data.device)
    else:
        dat = swap(block.data)
    return ind, dat


def _halo_csr(ind, dat, loc_iptr: np.ndarray, ncol: int) -> CSR:
    """A rank's halo B from its (indices, data) tensors and host indptr."""
    return CSR(data=dat, indices=ind, indptr=torch.from_numpy(loc_iptr).to(ind.device),
               shape=(len(loc_iptr) - 1, ncol), nnz=int(ind.shape[0]))


def _fetch_halo(Bh: CSR, block: CSR, halo: _Halo, n: int, me: int, group, pattern: bool):
    """This rank's halo B on the device of ``block``, this rank's own block
    of B row-block sharded (``_row_block``): the rest of its halo comes from
    the owners.  Returns the halo CSR and the maps (a revalue sends new
    values through them)."""
    maps = _exchange_maps(halo.rows, np.asarray(Bh.indptr, np.int64),
                          rows_per_shard(Bh.shape[0], n), me)
    ind, dat = _exchange_halo_body(block, *maps, me, group, pattern)
    return _halo_csr(ind, dat, halo.iptr[me], Bh.shape[1]), maps


# ---------------------------------------------------------------------------
# one rank's share
# ---------------------------------------------------------------------------


class _Shard:
    """One rank's share of a distributed product: the shared sizing and
    schedule of every shard, and this rank's shard on the host (``sub``,
    uploaded where a product runs).  With ``halo`` the shards are sized
    against their own halo B and this rank's shard is relabeled to its halo
    rows."""

    def __init__(self, S: ShardedCSR, B: CSR, mesh: DeviceMesh, axis: str, classes, W: int,
                 slot_budget: int, pattern, halo: _Halo | None = None):
        n = axis_size(mesh, axis)
        if S.n_shards != n:
            raise ValueError(f"matrix has {S.n_shards} shards, mesh axis {axis} has {n}")
        self.n, self.W = n, W
        self.classes = _norm_classes(classes, W)
        check_class_limit(self.classes, mesh_device(mesh))
        self.pattern = _detect_shard_pattern(S, B) if pattern is None else pattern
        A = S if halo is None else dataclasses.replace(S, indices=halo.rel)
        self.cls, self.counts, self.npa_max, _, _ = _per_shard_sizing(
            A, B, W, self.classes, None if halo is None else halo.iptr)
        ncls = len(self.classes)
        self.sched, self.starts, cnts, _ = _uniform_schedule(
            classes=self.classes, counts=self.counts[:, : ncls + 1], slot_budget=slot_budget
        )
        self.tail_per_shard = self.counts[:, ncls]
        self.me = mesh.get_local_rank(axis)
        self.group = mesh.get_group(axis)
        self.dev = mesh_device(mesh)
        self.rows_pad = S.rows_per_shard
        self.sc = np.stack([self.starts, cnts], axis=1)[self.me]  # (2, nchunks)
        self.nnz_pad = _round_up(self.npa_max * W, 1024)
        self.sub = local_shard(A, self.me, "cpu")
        if halo is not None:  # the relabeled shard's columns are its halo rows
            self.sub = dataclasses.replace(self.sub,
                                           shape=(S.rows_per_shard, len(halo.rows[self.me])))

    def kw(self, b_iptr, accum_dtype, pattern: bool | None = None) -> dict:
        """``_piece_exec``'s keywords against a B of host indptr ``b_iptr``."""
        return _piece_kw(b_iptr, self.W, self.npa_max, self.rows_pad, self.sched, self.starts,
                         accum_dtype, self.pattern if pattern is None else pattern)

    def rows_sorted(self) -> np.ndarray:
        """This shard's rows in stable class order (host)."""
        ncls = len(self.classes)
        return _stable_argsort_smallint(self.cls[self.me], ncls + 2).astype(np.int32)

    def tail_rows(self, rows_sorted: np.ndarray) -> np.ndarray:
        """This shard's tail rows (local ids) in class order."""
        base = int(self.counts[self.me, : len(self.classes)].sum())
        return rows_sorted[base : base + int(self.tail_per_shard[self.me])]

    def csr(self, B_dev: CSR, b_iptr, accum_dtype) -> CSR:
        """This shard's local CSR against ``B_dev`` (``ops.slab_spgemm._piece_csr``;
        its tail rows multiply the same B)."""
        return _piece_csr(self.sub, self.cls[self.me], self.counts[self.me], self.sc, B_dev,
                          self.dev, nclasses=len(self.classes), nnz_pad=self.nnz_pad,
                          kw=self.kw(b_iptr, accum_dtype))


def _all_gather_ragged(t: torch.Tensor, group, n: int) -> list:
    """Every rank's 1-D ``t`` of its own length, in rank order: the sizes
    first, then the payloads padded to the largest (tensor collectives only,
    nothing pickled)."""
    size = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = size.new_empty(n)
    dist.all_gather_into_tensor(sizes, size, group=group)
    sizes = sizes.tolist()
    width = max(max(sizes), 1)
    buf = t.new_zeros(width)
    buf[: t.shape[0]] = t
    out = t.new_empty(n * width)
    dist.all_gather_into_tensor(out, buf, group=group)
    return [out[r * width : r * width + sizes[r]] for r in range(n)]


def _gather_triples(C: CSR, group, dev, n: int):
    """Every rank's local CSR (host- or device-held, the same number of
    rows on every rank) gathered to every rank on ``dev``: (data list,
    indices list, indptr (n, rows + 1) int64), in rank order."""
    data = _all_gather_ragged(as_tensor(C.data[: C.nnz], dev), group, n)
    inds = _all_gather_ragged(as_tensor(C.indices[: C.nnz], dev).to(torch.int32), group, n)
    iptr = as_tensor(C.indptr, dev).long()
    iptrs = iptr.new_empty(n * iptr.shape[0])
    dist.all_gather_into_tensor(iptrs, iptr, group=group)
    return data, inds, iptrs.view(n, -1)


def _finish_global_csr(C: CSR, group, dev, row_starts, rows_pad: int, m: int) -> CSR:
    """Every rank's local CSR (its rows, B's columns) → the same global host
    CSR on every rank: the ranks' triples gathered through tensor
    collectives on ``dev`` and stitched there as the contiguous row blocks
    they are (no sort; the rows a shard's padding holds past ``m`` are cut),
    then one copy to the host."""
    row_starts = np.asarray(row_starts, np.int64)
    n = len(row_starts)
    data, inds, iptrs = _gather_triples(C, group, dev, n)
    parts, off = [iptrs[0, :1]], 0
    for s in range(n):
        own = max(min(rows_pad, m - int(row_starts[s])), 0)
        parts.append(iptrs[s, 1 : own + 1] + off)
        off += int(data[s].shape[0])
    indptr = torch.cat(parts)
    return CSR(data=torch.cat(data).cpu().numpy(), indices=torch.cat(inds).cpu().numpy(),
               indptr=indptr.cpu().numpy(), shape=(m, C.shape[1]), nnz=int(indptr[-1]))


def _finish(C: CSR, sh: _Shard, S: ShardedCSR) -> CSR:
    return _finish_global_csr(C, sh.group, sh.dev, S.row_starts, S.rows_per_shard, S.shape[0])


# ---------------------------------------------------------------------------
# one-shot products
# ---------------------------------------------------------------------------


def spgemm_dist_spmd(
    S: ShardedCSR,
    B: CSR,
    mesh: DeviceMesh,
    *,
    axis: str = "rows",
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=torch.float32,
    as_csr: bool = True,
    pattern: bool | None = None,
):
    """C = A @ B with A row-sharded over ``mesh[axis]``: every rank runs the
    same slab program on its row block, and every rank returns the same
    global host CSR.

    Rows whose padded expansion exceeds the largest class go through the
    rank's global-sort ESC during assembly.  With ``as_csr=False`` this
    rank's raw device outputs are returned as ``(rows_sorted, chunk_outputs,
    tail_rows)``, each with a leading axis of 1 (``tail_rows`` a list of this
    rank's tail row ids): the caller owns the tail rows, whose products are
    NOT in the chunk outputs.  ``pattern=None`` detects all-ones values
    (the reference's forced-1.0 semantics) and drops the value channels."""
    Bh = _host_b(B, mesh)
    sh = _Shard(S, Bh, mesh, axis, classes, seg_w, slot_budget, pattern)
    B_dev = Bh.to(sh.dev)
    if not as_csr:
        rs = sh.rows_sorted()
        rows_sorted, outs = _piece_exec(sh.sub.to(sh.dev), torch.from_numpy(rs).to(sh.dev), sh.sc, B_dev,
                                        **sh.kw(Bh.indptr, accum_dtype))
        return (rows_sorted[None], tuple(tuple(x[None] for x in o) for o in outs),
                [sh.tail_rows(rs)])
    # this rank's rows: compacted on the device, or, with tail rows, pulled
    # and joined with the tail rows' ESC products on the host
    return _finish(sh.csr(B_dev, Bh.indptr, accum_dtype), sh, S)


def spgemm_dist_csr(
    S: ShardedCSR,
    B: CSR,
    mesh: DeviceMesh,
    *,
    axis: str = "rows",
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=torch.float32,
    pattern: bool | None = None,
) -> ShardedCSR:
    """C = A @ B with the output kept **row-sharded on each rank's device**:
    every rank compacts its chunk outputs to a local CSR on the device (the
    distributed mirror of ``spgemm_slab_csr``), so C never transits the host
    and chains into further distributed ops.  Returns this rank's block
    (data / indices (1, nnz_pad), indptr (1, rows_pad + 1)); ``nnz`` is the
    sum of the per-shard counts over the axis (one all-reduce of a scalar).

    Requires no heavy-tail rows (their products live outside the slabs);
    raise the class ceiling or use :func:`spgemm_dist_spmd` for host
    assembly with the tail fallback."""
    Bh = _host_b(B, mesh)
    sh = _Shard(S, Bh, mesh, axis, classes, seg_w, slot_budget, pattern)
    if sh.tail_per_shard.sum():
        raise ValueError(
            "device-resident output requires no heavy-tail rows; raise the "
            "class ceiling or use spgemm_dist_spmd (host assembly)"
        )
    _, outs = _piece_exec(sh.sub.to(sh.dev), torch.from_numpy(sh.rows_sorted()).to(sh.dev), sh.sc,
                          Bh.to(sh.dev), **sh.kw(Bh.indptr, accum_dtype))
    data, indices, indptr, knnz = compact_to_csr(
        outs, nrow=S.rows_per_shard, nnz_pad=sh.nnz_pad, dtype=accum_dtype, device=sh.dev,
    )
    total = knnz.reshape(1).to(torch.int64)
    dist.all_reduce(total, group=sh.group)
    return ShardedCSR(
        data=data[None],
        indices=indices[None],
        indptr=indptr[None],
        row_starts=np.asarray(S.row_starts, np.int32),
        shape=(S.shape[0], B.shape[1]),
        n_shards=S.n_shards,
        rows_per_shard=S.rows_per_shard,
        nnz=int(total),
    )


def spgemm_dist_halo(
    S: ShardedCSR,
    B: CSR,
    mesh: DeviceMesh,
    *,
    axis: str = "rows",
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=torch.float32,
    pattern: bool | None = None,
) -> CSR:
    """C = A @ B, A row-sharded, with B **halo-restricted** per rank: each
    rank holds only the B rows its shard's columns reference, instead of a
    full replica (SpGEMM's halo, SURVEY.md §2.12; device memory per rank
    drops from nnz(B) to the shard's working set).  The halo is built on the
    host from the host B; the shard's column ids are relabeled to its halo
    rows, and its tail rows multiply the relabeled shard by that same halo.
    Every rank returns the same global host CSR."""
    Bh = _host_b(B, mesh)
    halo = _halo(S, np.asarray(Bh.indptr, np.int64))
    sh = _Shard(S, Bh, mesh, axis, classes, seg_w, slot_budget, pattern, halo=halo)
    Bl = _halo_b(Bh, halo.rows[sh.me], halo.iptr[sh.me])
    return _finish(sh.csr(Bl.to(sh.dev), Bl.indptr, accum_dtype), sh, S)


def spgemm_dist_halo_exchange(
    S: ShardedCSR,
    B: CSR,
    mesh: DeviceMesh,
    *,
    axis: str = "rows",
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=torch.float32,
    pattern: bool | None = None,
) -> CSR:
    """C = A @ B with B **row-block sharded** (``partition_rows(B, n)``) and
    each rank's halo fetched at run time by one ``all_to_all_single`` over
    the mesh axis (SURVEY.md §2.12's halo exchange; NVLink between cards).
    No device holds more of B than its own ``nnz(B) / n`` block plus its
    halo.  In pattern mode only column ids travel.  Tail rows multiply the
    relabeled shard by the same halo through the global-sort ESC.  Every
    rank returns the same global host CSR."""
    Bh = _host_b(B, mesh)
    halo = _halo(S, np.asarray(Bh.indptr, np.int64))
    sh = _Shard(S, Bh, mesh, axis, classes, seg_w, slot_budget, pattern, halo=halo)
    Bl, _ = _fetch_halo(Bh, _row_block(Bh, sh.n, sh.me, sh.dev), halo, sh.n, sh.me, sh.group,
                        sh.pattern)
    return _finish(sh.csr(Bl, halo.iptr[sh.me], accum_dtype), sh, S)


# ---------------------------------------------------------------------------
# two-phase distributed SpGEMM (plan once / multiply many, the distributed
# mirror of ops.slab_spgemm.spgemm_plan and its class-aligned cache)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _DistRebuild:
    """What :func:`spgemm_dist_revalue` reuses from a plan, all of it on the
    host: the shared sizing and schedule and this rank's (relabeled) shard
    (``shard``), B's indptr the tables were sized with (``b_iptr``: the
    halo's with ``b_sharded``), and with ``b_sharded`` this rank's halo
    column ids and the exchange maps (send indices, pair sizes)."""

    shard: _Shard
    b_iptr: np.ndarray
    b_sharded: bool
    a_nnz: int
    b_nnz: int
    halo_ind: torch.Tensor | None = None
    maps: tuple | None = None


@dataclasses.dataclass
class DistSpgemmPlan:
    """This rank's symbolic phase of a row-sharded C = A @ B: its
    class-aligned blocks of partial products (one per chunk of the shared
    schedule) on the mesh's device, its (start, count) per chunk, and its
    tail rows' products, computed once on the plan's values.  Re-execution
    (:func:`spgemm_dist_exec`) sorts and merges the blocks: no gather from
    B, no collective before the assembly."""

    rows_sorted: torch.Tensor  #: this rank's rows in class order (padded), on the device
    sc: np.ndarray  #: (2, nchunks) this rank's (start, count) per chunk
    aligned_cols: tuple  #: (R_pad, L) column blocks, one per chunk
    aligned_vals: tuple  #: value blocks (empty in pattern mode)
    schedule: tuple  #: ((L, R_pad), ...), the same on every rank
    tail: tuple | None  #: this rank's tail rows' (rows, cols, vals), host; None without
    row_starts: np.ndarray
    rows_per_shard: int
    shape: tuple
    axis: str
    pattern: bool
    accum_dtype: object
    n_shards: int
    nnz_pad: int  #: bound of this rank's compacted output
    rebuild: _DistRebuild  #: structure-only metadata for spgemm_dist_revalue


def _build_plan(rb: _DistRebuild, sub: CSR, B_dev: CSR, pattern: bool, accum_dtype,
                S: ShardedCSR, axis: str) -> DistSpgemmPlan:
    """The tables of this rank's host shard ``sub`` (relabeled with a halo
    B) against ``B_dev``, every chunk's aligned block, and the tail rows'
    products of the same shard with the same B."""
    sh = rb.shard
    kw = sh.kw(rb.b_iptr, accum_dtype, pattern)
    rs = sh.rows_sorted()
    t = _plan_tables(sub.to(sh.dev), B_dev, torch.from_numpy(rs).to(sh.dev), W=sh.W,
                     npa_pad=kw["npa_pad"], nsegB_pad=kw["nsegB_pad"], nrow_pad=kw["nrow_pad"],
                     pattern=pattern)
    slabs = chunk_fetch_all(t, [(L, R_pad, int(sh.sc[0, i]), int(sh.sc[1, i])) for i, (L, R_pad) in enumerate(sh.sched)],
                            W=sh.W, accum_dtype=accum_dtype, pattern=pattern)
    cols = [col for col, _ in slabs]
    vals = [] if pattern else [val for _, val in slabs]
    trows = sh.tail_rows(rs).astype(np.int64)
    tail = _tail_products(sub.host(), trows, B_dev, accum_dtype, sh.dev) if len(trows) else None
    return DistSpgemmPlan(
        rows_sorted=t.rows_sorted, sc=sh.sc, aligned_cols=tuple(cols), aligned_vals=tuple(vals),
        schedule=tuple(sh.sched), tail=tail, row_starts=np.asarray(S.row_starts, np.int64),
        rows_per_shard=S.rows_per_shard, shape=(S.shape[0], B_dev.shape[1]), axis=axis,
        pattern=pattern, accum_dtype=accum_dtype, n_shards=S.n_shards, nnz_pad=sh.nnz_pad,
        rebuild=rb,
    )


def spgemm_dist_plan(
    S: ShardedCSR,
    B: CSR,
    mesh: DeviceMesh,
    *,
    axis: str = "rows",
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=torch.float32,
    pattern: bool | None = None,
    b_sharded: bool = False,
) -> DistSpgemmPlan:
    """Distributed symbolic phase of C = A @ B (A row-sharded): the shared
    sizing and schedule, then this rank's tables and class-aligned blocks on
    the mesh's device, and its tail rows' products.  Returns this rank's
    plan.

    ``b_sharded=False``: B replicated on every rank's device.
    ``b_sharded=True``: B row-block sharded; each rank's halo is fetched by
    the runtime exchange (:func:`spgemm_dist_halo_exchange`'s
    ``all_to_all_single``) at plan time only, so :func:`spgemm_dist_exec`
    runs no collective before the assembly and no device holds a full B
    replica (BASELINE config 5; SURVEY.md §2.12)."""
    Bh = _host_b(B, mesh)
    b_iptr = np.asarray(Bh.indptr, np.int64)
    halo = _halo(S, b_iptr) if b_sharded else None
    sh = _Shard(S, Bh, mesh, axis, classes, seg_w, slot_budget, pattern, halo=halo)
    rb = _DistRebuild(shard=sh, b_iptr=b_iptr, b_sharded=b_sharded, a_nnz=S.nnz, b_nnz=B.nnz)
    if b_sharded:
        B_dev, rb.maps = _fetch_halo(Bh, _row_block(Bh, sh.n, sh.me, sh.dev), halo, sh.n, sh.me,
                                     sh.group, sh.pattern)
        rb.b_iptr, rb.halo_ind = halo.iptr[sh.me], B_dev.indices.cpu()
    else:
        B_dev = Bh.to(sh.dev)
    return _build_plan(rb, sh.sub, B_dev, sh.pattern, accum_dtype, S, axis)


def spgemm_dist_revalue(plan: DistSpgemmPlan, S: ShardedCSR, B: CSR,
                        mesh: DeviceMesh) -> DistSpgemmPlan:
    """A new distributed plan for NEW VALUES on the SAME sparsity structure,
    the distributed mirror of ``ops.slab_spgemm.spgemm_plan_revalue`` (the
    cuSPARSE spgemm-reuse contract: iterative workloads update values each
    step, structure fixed).  Reuses the plan's sizing, schedule, relabeled
    shard and exchange maps; with ``b_sharded`` only B's new values travel,
    through the same maps.  Pattern mode is detected again on the new
    values: a plan built from all-ones values gains its value channels (the
    JAX package keeps the plan's mode there and ignores the new values).
    The caller guarantees S and B carry the plan's structure; a different
    nnz raises ValueError, as cuSPARSE checks."""
    rb = plan.rebuild
    if S.nnz != rb.a_nnz or B.nnz != rb.b_nnz:
        raise ValueError(
            f"operand structure differs from the plan's: nnz {S.nnz}/{B.nnz} "
            f"vs plan {rb.a_nnz}/{rb.b_nnz}"
        )
    Bh = _host_b(B, mesh)
    sh = rb.shard
    pattern = _detect_shard_pattern(S, Bh)
    sub = dataclasses.replace(sh.sub, data=local_shard(S, sh.me, "cpu").data)
    if rb.b_sharded:
        ind = rb.halo_ind.to(sh.dev)
        if pattern:
            dat = torch.ones(ind.shape[0], dtype=as_tensor(Bh.data[:0], "cpu").dtype, device=sh.dev)
        else:  # only B's values travel, through the plan's maps
            block = _row_block(Bh, sh.n, sh.me, sh.dev)
            _, dat = _exchange_halo_body(block, *rb.maps, sh.me, sh.group, False, values_only=True)
        B_dev = _halo_csr(ind, dat, rb.b_iptr, Bh.shape[1])
    else:
        B_dev = Bh.to(sh.dev)
    return _build_plan(rb, sub, B_dev, pattern, plan.accum_dtype, S, plan.axis)


def spgemm_dist_exec(plan: DistSpgemmPlan, mesh: DeviceMesh, *, as_csr: bool = True):
    """Numeric phase over this rank's :class:`DistSpgemmPlan`: sort and merge
    each aligned block (no gather from B, no collective), then this rank's
    compaction with its tail rows merged in, and the global host CSR that
    every rank returns (``as_csr=True``).  ``as_csr=False`` returns this
    rank's raw chunk outputs ``(rows, cols_u, vals_u, nuniq)`` per chunk,
    each with a leading axis of 1; the tail rows' products are the plan's
    ``tail``."""
    check_on_mesh(mesh, plan.rows_sorted, "the plan")
    merged = slab_merge_all(plan.aligned_cols, plan.aligned_vals, accum_dtype=plan.accum_dtype,
                            pattern=plan.pattern)
    outs = [(plan.rows_sorted[int(plan.sc[0, i]) : int(plan.sc[0, i]) + R_pad],) + m
            for i, ((_, R_pad), m) in enumerate(zip(plan.schedule, merged))]
    if not as_csr:
        return tuple(tuple(x[None] for x in o) for o in outs)
    dev = mesh_device(mesh)
    C = _local_csr(outs, plan.tail, (plan.rows_per_shard, plan.shape[1]), plan.nnz_pad,
                   plan.accum_dtype, dev)
    return _finish_global_csr(C, mesh.get_group(plan.axis), dev, plan.row_starts,
                              plan.rows_per_shard, plan.shape[0])


# ---------------------------------------------------------------------------
# the streamed distributed SpGEMM: the big path over a device mesh (BASELINE
# config 5 end to end: spgemm_slab_big's pieces inside each rank's rows)
# ---------------------------------------------------------------------------


def _agree(ok: bool, group, dev) -> bool:
    """True on every rank when ``ok`` holds on every rank (a MIN all-reduce;
    also a barrier)."""
    t = torch.tensor([int(bool(ok))], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(t.item())


def _dist_checkpoint(me: int, group, dev, *args, **kw) -> _BigCheckpoint:
    """The big path's checkpoint on every rank: rank 0 writes (or checks)
    the manifest first, then the others check it, read only.  A refusal on
    any rank raises on every rank (no rank is left in a collective)."""
    ck, err = None, None
    if me == 0:
        try:
            ck = _BigCheckpoint(*args, writer=True, **kw)
        except ValueError as e:
            err = e
    written = _agree(err is None, group, dev)
    if me != 0:  # after rank 0 wrote the manifest, or refused the directory
        try:
            ck = _BigCheckpoint(*args, writer=False, **kw)
        except ValueError as e:
            err = e
    if not _agree(err is None, group, dev) or not written:
        raise err or ValueError("the big path's checkpoint was refused on another rank")
    return ck


def _load_piece(ck: _BigCheckpoint, p: int, n: int, me: int, group, dev):
    """Piece ``p``'s triples from the checkpoint, or None on every rank
    unless every rank read them.  Rank 0 reads first (and drops a torn
    file); the others read once it has."""
    got = ck.load_multi(p, n) if me == 0 else None
    if not _agree(me != 0 or got is not None, group, dev):
        return None
    if me != 0:
        got = ck.load_multi(p, n)
    return got if _agree(got is not None, group, dev) else None


def spgemm_dist_big(
    A: CSR,
    B: CSR,
    mesh: DeviceMesh,
    *,
    axis: str = "rows",
    pieces: int | None = None,
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=torch.float32,
    pattern: bool | None = None,
    checkpoint_dir: str | None = None,
    b_sharded: bool = False,
) -> CSR:
    """C = A @ B streamed over a device mesh, BASELINE config 5 end to end:
    the row-partitioned SpGEMM at the scale where neither the plan tables
    nor the output fit one product.

    The outer split is the mesh: A's rows are block-sharded over
    ``mesh[axis]``.  The inner split is streaming: each rank's rows are cut
    into ``P`` uniform pieces, blocks ``b = s·P + p``, all sharing one chunk
    schedule; rank ``s`` runs its pieces ``p = 0..P-1`` through
    ``_piece_csr``, and after each piece every rank's triple is gathered to
    every rank.  ``pieces`` defaults to the smallest power of two whose
    blocks' slab slots (tail rows' pairs take none) fit ``_MAX_EXP_PAD``.
    Heavy-tail rows take the global-sort ESC; a schedule with no chunk at
    all (every row past the class ceiling) runs the tails alone.

    ``b_sharded=True``: B row-block sharded; each piece's halo is fetched by
    the runtime exchange (``all_to_all_single``), so no device holds a full
    B replica.  ``checkpoint_dir`` persists each finished piece (every
    rank's triple in one file, manifest pinned by sha256, the shard count
    and the B layout) and a re-run resumes after them.  It must be one
    directory that every rank sees: rank 0 alone writes it.  Every rank
    returns the same global host CSR."""
    n = axis_size(mesh, axis)
    me, group, dev = mesh.get_local_rank(axis), mesh.get_group(axis), mesh_device(mesh)
    W = seg_w
    classes = _norm_classes(classes, W)
    check_class_limit(classes, dev)
    Bh = _host_b(B, mesh)
    if pattern is None:
        pattern = _is_pattern(A) and _is_pattern(Bh)

    P, S, (cls, counts, npa_max, nnz_s, _), body_max = _choose_pieces(
        A, Bh, W, classes, pieces, 1, nsh=n)
    ncls = len(classes)
    sched, starts, cnts, _ = _uniform_schedule(classes=classes, counts=counts[:, : ncls + 1],
                                               slot_budget=slot_budget)
    sc_tab = np.stack([starts, cnts], axis=1)  # (n * P, 2, nchunks)
    rows_pad = S.rows_per_shard
    b_iptr = np.asarray(Bh.indptr, np.int64)
    # only tail-free blocks compact on the device, and their pairs are all body
    nnz_pad = _round_up(body_max * W, 1024)
    # B on the device: this rank's block of it (sharded), or all of it
    B_dev = _row_block(Bh, n, me, dev) if b_sharded else Bh.to(dev)
    kw = _piece_kw(b_iptr, W, npa_max, rows_pad, sched, starts, accum_dtype, pattern)
    ck = None
    if checkpoint_dir is not None:
        ck = _dist_checkpoint(me, group, dev, checkpoint_dir, A, B, P, classes, W, slot_budget,
                              _dtype_name(accum_dtype), pattern,
                              extra={"dist_nsh": int(n), "b_sharded": bool(b_sharded)})

    piece_triples = []
    for p in range(P):
        got = None if ck is None else _load_piece(ck, p, n, me, group, dev)
        if got is not None:
            piece_triples.append(got)
            continue
        b = me * P + p
        sub = CSR(data=S.data[b], indices=S.indices[b], indptr=S.indptr[b].astype(np.int64),
                  shape=(rows_pad, A.shape[1]), nnz=int(nnz_s[b]))
        if b_sharded:
            blocks = np.arange(n) * P + p  # piece p of every rank
            halo = _halo(dataclasses.replace(S, indices=S.indices[blocks], indptr=S.indptr[blocks],
                                             n_shards=n), b_iptr)
            B_loc, _ = _fetch_halo(Bh, B_dev, halo, n, me, group, pattern)
            rel = dataclasses.replace(sub, indices=halo.rel[me], shape=(rows_pad, len(halo.rows[me])))
            kw_p = _piece_kw(halo.iptr[me], W, npa_max, rows_pad, sched, starts, accum_dtype,
                             pattern)
            C = _piece_csr(rel, cls[b], counts[b], sc_tab[b], B_loc, dev, nclasses=ncls,
                           nnz_pad=nnz_pad, kw=kw_p)
        else:
            C = _piece_csr(sub, cls[b], counts[b], sc_tab[b], B_dev, dev, nclasses=ncls,
                           nnz_pad=nnz_pad, kw=kw)
        data, inds, iptrs = _gather_triples(C, group, dev, n)
        triples = [(d.cpu().numpy(), i.cpu().numpy(), ip.cpu().numpy())
                   for d, i, ip in zip(data, inds, iptrs)]
        del C, data, inds, iptrs
        if ck is not None and me == 0:
            ck.save_multi(p, triples)
        piece_triples.append(triples)
    if ck is not None:
        _agree(True, group, dev)  # every piece file is written before any rank goes on

    # blocks in global row order: b = s * P + p ascending
    return _stitch([piece_triples[p][s] for s in range(n) for p in range(P)], A.nrow, B.shape[1])
