"""Scatter-free SpMM/SpMV over the ELL format (port of
``spmm_tpu/ops/ell_spmm.py``).

Per length-class slab (R, L), kernel K2 (``ops/ell_kernel.py``) gathers the B
rows of the slab's columns, weights them by the slab values and sums over L,
writing straight into the slab's rows of the length-sorted output; the
leftover long rows use the gather + ``index_add_`` path (they are few); one
gather un-permutes to the original row order.

The JAX package's narrow-k widen/fold/select strategies (``PICK_IMPL``) were
a 128-lane layout device and are not ported: K2 takes any k.
"""

from __future__ import annotations

import torch

from spmm_tpu_torch.formats.containers import as_tensor
from spmm_tpu_torch.formats.ell import ELL
from spmm_tpu_torch.ops.ell_kernel import ell_slab_spmm


def ell_spmm(E: ELL, B: torch.Tensor, *, permute_back: bool = True) -> torch.Tensor:
    """Y[m, k] = A @ B in fp32 for A in ELL form, on B's device."""
    from spmm_tpu_torch.ops.spmm import spmm_xla

    dev = B.device
    m = E.shape[0]
    y = torch.empty((m, B.shape[1]), dtype=torch.float32, device=dev)
    y[: E.n_empty].zero_()
    row = E.n_empty
    for slab_d, slab_c in zip(E.data, E.cols):
        R = slab_d.shape[0]
        ell_slab_spmm(as_tensor(slab_c, dev), as_tensor(slab_d, dev), B, out=y[row : row + R])
        row += R
    if E.n_rest_rows:
        y[row:] = spmm_xla(E.rest.to(dev), B)[: E.n_rest_rows]
    if not permute_back:
        return y
    return y.index_select(0, as_tensor(E.inv_perm, dev).long())


def ell_spmv(E: ELL, x: torch.Tensor, *, permute_back: bool = True) -> torch.Tensor:
    """y[m] = A @ x for A in ELL form (K2 with k = 1)."""
    return ell_spmm(E, x[:, None], permute_back=permute_back)[:, 0]
