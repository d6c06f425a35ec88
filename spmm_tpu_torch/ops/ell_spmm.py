"""Scatter-free SpMM/SpMV over the ELL format (port of
``spmm_tpu/ops/ell_spmm.py``).

Kernel K2 (``ops/ell_kernel.py``) takes every length-class slab (R, L) in
one launch: it gathers the B rows of each slab's columns, weights them by the
slab values and sums over L, writing each slab row straight into its row of
the output in the original row order, through K2's row map (its work table
is memoized on the ELL and walks the rows in that order, for L2 locality);
the empty rows are filled by one ``index_fill_``: no un-permute gather, and
so no atomic ``index_add_`` in the backward either.  The leftover long rows
(``E.rest``, longer than the pack's ``max_len``) ride in the same launch,
cut into pieces of at most ``T_CUT`` entries laid out as more slabs
(``ell_kernel.RestPieces``, built once per pack): a cut row's pieces are
written to scratch rows and joined by one ordered segment sum, and the
backward runs them on K2 over the transposed pack and on K3 as the pack's
rows; their values are reordered from the CSR's order to the pieces' by one
scalar gather.  ``permute_back=False`` returns the length-sorted order
(empty rows, slab rows, leftover rows), the leftover rows by the gather +
ordered segment sum of ``spmm_xla``.

The JAX package's narrow-k widen/fold/select strategies (``PICK_IMPL``) were
a 128-lane layout device and are not ported: K2 takes any k.
"""

from __future__ import annotations

import types

import torch

from spmm_tpu_torch.formats.containers import as_numpy, as_tensor
from spmm_tpu_torch.formats.ell import ELL
from spmm_tpu_torch.ops.ell_kernel import (
    RestPieces,
    ell_slabs_spmm_into,
    ell_slabs_spmm_mapped,
    rest_pieces,
    table_memo,
)
from spmm_tpu_torch.utils.profiling import span


def slab_row_keys(E: ELL):
    """The original row of each slab row: K2 runs its work in that order,
    since neighbouring rows of a graph share columns and the CTAs in flight
    then share B rows through L2."""
    return as_numpy(E.perm)[E.n_empty : E.shape[0] - E.n_rest_rows]


def _row_maps(E: ELL, device):
    """``(out_rows, rest_rows, zero_rows)`` on ``device``: the original row
    of each slab row (int32, K2's row map), of each leftover row and of each
    empty row (int64); memoized beside the ELL's work tables."""
    memo = table_memo(E)
    key = ("rows", device)
    if memo is not None and key in memo:
        return memo[key]
    perm = as_tensor(E.perm, device).long()
    row = E.shape[0] - E.n_rest_rows
    maps = (perm[E.n_empty : row].to(torch.int32).contiguous(), perm[row:].contiguous(),
            perm[: E.n_empty].contiguous())
    if memo is not None:
        memo[key] = maps
    return maps


def _pieces(E: ELL, device) -> RestPieces:
    """E's slabs and its leftover rows as pieces on ``device``
    (:func:`ell_kernel.rest_pieces`), memoized beside its work tables; for
    an ELL with leftover rows."""
    memo = table_memo(E)
    key = ("pieces", device)
    if memo is not None and key in memo:
        return memo[key]
    out_rows, rest_rows, _ = _row_maps(E, device)
    P = rest_pieces(E.cols, out_rows, lambda: slab_row_keys(E), E.rest, rest_rows, E.shape[0], device)
    if memo is not None:
        memo[key] = P
    return P


def _slabs_of(E: ELL, device):
    """What K2 and K3 run over for E on ``device``: ``cols``, K2's row map
    ``write_rows``, the map ``read_rows`` that K3 and the transposed pack
    read by, the ``memo`` of their tables, ``row_keys`` and ``pieces`` --
    E's slabs, each map its row map, or with leftover rows :func:`_pieces`'
    slabs and maps."""
    if E.n_rest_rows:
        P = _pieces(E, device)
        return types.SimpleNamespace(cols=P.cols, write_rows=P.write_rows, read_rows=P.read_rows, memo=P.memo,
                                     row_keys=P.row_keys, pieces=P)
    out_rows = _row_maps(E, device)[0]
    return types.SimpleNamespace(cols=E.cols, write_rows=out_rows, read_rows=out_rows, memo=table_memo(E),
                                 row_keys=lambda: slab_row_keys(E), pieces=None)


def fold_batch(B: torch.Tensor):
    """``(B2, b)``: a stack (b, n, k) of right-hand sides folded into the
    column axis, (n, b·k), so that one product serves the whole stack; a
    plain (n, k) passes through with b None."""
    if B.dim() == 2:
        return B, None
    if B.dim() != 3:
        raise ValueError(f"B must be (n, k) or a stack (b, n, k), got {tuple(B.shape)}")
    b, n, k = B.shape
    return B.permute(1, 0, 2).reshape(n, b * k), b


def unfold_batch(y: torch.Tensor, b: int | None) -> torch.Tensor:
    """(m, b·k) back to the stack (b, m, k); the inverse of :func:`fold_batch`."""
    if b is None:
        return y
    return y.reshape(y.shape[0], b, -1).permute(1, 0, 2)


def ell_spmm(E: ELL, B: torch.Tensor, *, accum_dtype=torch.float32,
             permute_back: bool = True) -> torch.Tensor:
    """Y[m, k] = A @ B for A in ELL form, on B's device, summed and returned
    in ``accum_dtype`` (fp32 as in the JAX package; pass ``torch.float64``
    for fp64 values and B -- on the card fp64 runs on K2 when both are fp64,
    and a mix the kernel does not take raises).  B may be a stack (b, n, k):
    the batched form (what ``vmap`` over B is in the JAX package), returned
    as (b, m, k), computed as ONE product over (n, b·k).  Gradients flow to
    B and to the slab values ``E.data`` (``ops/ell_kernel.py``)."""
    from spmm_tpu_torch.ops.spmm import spmm_xla

    with span("spmm.ell_spmm"):
        B, batch = fold_batch(B)
        dev = B.device
        m = E.shape[0]
        if permute_back:
            on = _slabs_of(E, dev)
            data = E.data if on.pieces is None else (*E.data, *on.pieces.slabs(as_tensor(E.rest.data, dev)))
            y = ell_slabs_spmm_mapped(on.cols, data, B, on.write_rows, m, zero_rows=_row_maps(E, dev)[2],
                                      memo=on.memo, row_keys=on.row_keys, accum_dtype=accum_dtype,
                                      pieces=on.pieces)
            return unfold_batch(y, batch)
        row = m - E.n_rest_rows
        y = torch.empty((m, B.shape[1]), dtype=accum_dtype, device=dev)
        y[: E.n_empty].zero_()
        if E.data:
            ell_slabs_spmm_into(y, E.n_empty, E.cols, E.data, B, memo=table_memo(E),
                                row_keys=lambda: slab_row_keys(E), accum_dtype=accum_dtype)
        if E.n_rest_rows:
            y[row:] = spmm_xla(E.rest.to(dev), B, accum_dtype=accum_dtype)[: E.n_rest_rows]
        return unfold_batch(y, batch)


def ell_spmv(E: ELL, x: torch.Tensor, *, accum_dtype=torch.float32,
             permute_back: bool = True) -> torch.Tensor:
    """y[m] = A @ x for A in ELL form (K2 with k = 1)."""
    return ell_spmm(E, x[:, None], accum_dtype=accum_dtype, permute_back=permute_back)[:, 0]
