"""SDDMM — sampled dense-dense matrix multiplication (port of
``spmm_tpu/ops/sddmm.py``).

``C[i, j] = (U @ V^T)[i, j]`` for ``(i, j)`` in A's sparsity pattern
(optionally scaled by A's values): the companion op to SpMM in sparse
frameworks (graph attention scores, low-rank residual sampling).  Two row
gathers (U by each nonzero's row, V by its column) and a row sum, in fp32;
no scatter, and the values land in CSR nonzero order.
"""

from __future__ import annotations

import dataclasses

import torch

from spmm_tpu_torch.formats.containers import CSR, as_tensor
from spmm_tpu_torch.ops.segments import boundary_segments


def sddmm_values(A: CSR, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Per-nonzero values ``(U @ V^T)[row_e, col_e]`` in fp32, on U's device
    (length = padded nnz; padding positions carry samples of the last row, so
    mask them or slice to ``A.nnz``)."""
    dev = U.device
    rows = boundary_segments(A.indptr, A.nnz_pad, dtype=torch.int64, device=dev)
    u = U.index_select(0, rows).float()
    v = V.index_select(0, as_tensor(A.indices, dev).long()).float()
    return (u * v).sum(1)


def sddmm(A: CSR, U: torch.Tensor, V: torch.Tensor, *, scale_by_values: bool = False) -> CSR:
    """CSR with A's pattern and SDDMM values (optionally ``A.data *`` them),
    every leaf on U's device.  The padding tail is zero, so a padded CSR
    stays canonical."""
    dev = U.device
    vals = sddmm_values(A, U, V)
    if scale_by_values:
        vals = vals * as_tensor(A.data, dev)  # the padding's data is zero
    else:
        vals[A.nnz :] = 0
    return dataclasses.replace(A, data=vals).to(dev)
