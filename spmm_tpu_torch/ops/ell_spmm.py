"""Scatter-free SpMM/SpMV over the ELL format (port of
``spmm_tpu/ops/ell_spmm.py``).

Kernel K2 (``ops/ell_kernel.py``) takes every length-class slab (R, L) in
one launch: it gathers the B rows of each slab's columns, weights them by the
slab values and sums over L, writing each slab row straight into its row of
the output in the original row order, through K2's row map (its work table
is memoized on the ELL and walks the rows in that order, for L2 locality);
the leftover long rows use the gather + ordered segment sum path (they are
few) and are placed by one ``index_copy_``, the empty rows by one
``index_fill_``: no un-permute gather, and so no atomic ``index_add_`` in
the backward either.  ``permute_back=False`` returns the length-sorted
order (empty rows, slab rows, leftover rows).

The JAX package's narrow-k widen/fold/select strategies (``PICK_IMPL``) were
a 128-lane layout device and are not ported: K2 takes any k.
"""

from __future__ import annotations

import torch

from spmm_tpu_torch.formats.containers import as_numpy, as_tensor
from spmm_tpu_torch.formats.ell import ELL
from spmm_tpu_torch.ops.ell_kernel import ell_slabs_spmm_into, ell_slabs_spmm_mapped, table_memo
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
        row = m - E.n_rest_rows
        rest = spmm_xla(E.rest.to(dev), B, accum_dtype=accum_dtype)[: E.n_rest_rows] if E.n_rest_rows else None
        if permute_back:
            out_rows, rest_rows, zero_rows = _row_maps(E, dev)
            y = ell_slabs_spmm_mapped(E.cols, E.data, B, out_rows, m, rest=rest, rest_rows=rest_rows,
                                      zero_rows=zero_rows, memo=table_memo(E),
                                      row_keys=lambda: slab_row_keys(E), accum_dtype=accum_dtype)
            return unfold_batch(y, batch)
        y = torch.empty((m, B.shape[1]), dtype=accum_dtype, device=dev)
        y[: E.n_empty].zero_()
        if E.data:
            ell_slabs_spmm_into(y, E.n_empty, E.cols, E.data, B, memo=table_memo(E),
                                row_keys=lambda: slab_row_keys(E), accum_dtype=accum_dtype)
        if rest is not None:
            y[row:] = rest
        return unfold_batch(y, batch)


def ell_spmv(E: ELL, x: torch.Tensor, *, accum_dtype=torch.float32,
             permute_back: bool = True) -> torch.Tensor:
    """y[m] = A @ x for A in ELL form (K2 with k = 1)."""
    return ell_spmm(E, x[:, None], accum_dtype=accum_dtype, permute_back=permute_back)[:, 0]
