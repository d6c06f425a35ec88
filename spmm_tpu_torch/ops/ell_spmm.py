"""Scatter-free SpMM/SpMV over the ELL format (port of
``spmm_tpu/ops/ell_spmm.py``).

Kernel K2 (``ops/ell_kernel.py``) takes every length-class slab (R, L) in
one launch: it gathers the B rows of each slab's columns, weights them by the
slab values and sums over L, writing straight into the slab's rows of the
length-sorted output (its work table is memoized on the ELL and walks the
rows in their original order, for L2 locality); the leftover
long rows use the gather + ``index_add_`` path (they are few); one gather
un-permutes to the original row order.

The JAX package's narrow-k widen/fold/select strategies (``PICK_IMPL``) were
a 128-lane layout device and are not ported: K2 takes any k.
"""

from __future__ import annotations

import torch

from spmm_tpu_torch.formats.containers import as_numpy, as_tensor
from spmm_tpu_torch.formats.ell import ELL
from spmm_tpu_torch.ops.ell_kernel import ell_slabs_spmm, table_memo


def slab_row_keys(E: ELL):
    """The original row of each slab row: K2 runs its work in that order,
    since neighbouring rows of a graph share columns and the CTAs in flight
    then share B rows through L2."""
    return as_numpy(E.perm)[E.n_empty : E.shape[0] - E.n_rest_rows]


def ell_spmm(E: ELL, B: torch.Tensor, *, permute_back: bool = True) -> torch.Tensor:
    """Y[m, k] = A @ B in fp32 for A in ELL form, on B's device."""
    from spmm_tpu_torch.ops.spmm import spmm_xla

    dev = B.device
    m = E.shape[0]
    y = torch.empty((m, B.shape[1]), dtype=torch.float32, device=dev)
    y[: E.n_empty].zero_()
    row = m - E.n_rest_rows
    if E.data:
        ell_slabs_spmm(E.cols, E.data, B, y[E.n_empty : row], memo=table_memo(E),
                       row_keys=lambda: slab_row_keys(E))
    if E.n_rest_rows:
        y[row:] = spmm_xla(E.rest.to(dev), B)[: E.n_rest_rows]
    if not permute_back:
        return y
    return y.index_select(0, as_tensor(E.inv_perm, dev).long())


def ell_spmv(E: ELL, x: torch.Tensor, *, permute_back: bool = True) -> torch.Tensor:
    """y[m] = A @ x for A in ELL form (K2 with k = 1)."""
    return ell_spmm(E, x[:, None], permute_back=permute_back)[:, 0]
