"""SDDMM — sampled dense-dense matrix multiplication (port of
``spmm_tpu/ops/sddmm.py``).

``C[i, j] = (U @ V^T)[i, j]`` for ``(i, j)`` in A's sparsity pattern
(optionally scaled by A's values): the companion op to SpMM in sparse
frameworks (graph attention scores, low-rank residual sampling).  Two row
gathers (U by each nonzero's row, V by its column) and a row sum, in
``accum_dtype`` (fp32 by default); no scatter, and the values land in CSR
nonzero order.  Plain torch ops on every device (XLA in the JAX package), so
gradients flow to U, V and, with ``scale_by_values``, to A's values.
"""

from __future__ import annotations

import dataclasses

import torch

from spmm_tpu_torch.formats.containers import CSR, as_tensor
from spmm_tpu_torch.ops.segments import boundary_segments


def sddmm_values(A: CSR, U: torch.Tensor, V: torch.Tensor, *,
                 accum_dtype=torch.float32) -> torch.Tensor:
    """Per-nonzero values ``(U @ V^T)[row_e, col_e]`` in ``accum_dtype``, on U's device
    (length = padded nnz; padding positions carry samples of the last row, so
    mask them or slice to ``A.nnz``)."""
    dev = U.device
    rows = boundary_segments(A.indptr, A.nnz_pad, dtype=torch.int64, device=dev)
    u = U.index_select(0, rows).to(accum_dtype)
    v = V.index_select(0, as_tensor(A.indices, dev).long()).to(accum_dtype)
    return (u * v).sum(1)


def sddmm(A: CSR, U: torch.Tensor, V: torch.Tensor, *, scale_by_values: bool = False,
          accum_dtype=torch.float32) -> CSR:
    """CSR with A's pattern and SDDMM values (optionally ``A.data *`` them),
    every leaf on U's device.  The padding tail is zero, so a padded CSR
    stays canonical."""
    dev = U.device
    vals = sddmm_values(A, U, V, accum_dtype=accum_dtype)
    if scale_by_values:
        vals = vals * as_tensor(A.data, dev).to(accum_dtype)  # the padding's data is zero
    else:
        vals[A.nnz :] = 0
    return dataclasses.replace(A, data=vals).to(dev)
