"""SpMM / SpMV — sparse × dense products (port of ``spmm_tpu/ops/spmm.py``).

- ``spmm_xla`` / ``spmv_xla``: plain PyTorch gather + ``index_add_`` (the
  counterparts of the JAX package's XLA gather + segment-sum paths).  Correct
  for any CSR, padded or tight.
- ``spmm`` / ``spmv``: dispatchers on the input format — ELL (kernel K2), BSR
  (kernel K1), CSR (large CSRs pack to ELL once, memoized per instance).

Results are fp32; values may be stored bf16 or fp32 (fp64 parity is a later
slice).
Containers holding numpy arrays are moved to the device of the dense operand.
"""

from __future__ import annotations

import weakref

import torch

from spmm_tpu_torch.formats.bsr import BSR
from spmm_tpu_torch.formats.containers import CSR, BlockedCSR, as_tensor
from spmm_tpu_torch.formats.ell import ELL, ell_pack
from spmm_tpu_torch.ops.bsr_kernel import bsr_spmm
from spmm_tpu_torch.ops.ell_spmm import ell_spmm, ell_spmv
from spmm_tpu_torch.ops.segments import boundary_segments


def _row_ids(A: CSR, device) -> torch.Tensor:
    return boundary_segments(A.indptr, A.nnz_pad, dtype=torch.int64, device=device)


def spmm_xla(A: CSR, B: torch.Tensor) -> torch.Tensor:
    """Y[m, k] = A[m, n] @ B[n, k] in fp32 via row gather + ``index_add_``.
    Padded nonzeros (data == 0) contribute nothing, so no masking is needed."""
    dev = B.device
    rows = _row_ids(A, dev)
    gathered = B.index_select(0, as_tensor(A.indices, dev).long()).float()
    contrib = gathered * as_tensor(A.data, dev).float()[:, None]
    y = torch.zeros((A.shape[0], B.shape[1]), dtype=torch.float32, device=dev)
    return y.index_add_(0, rows, contrib)


def spmv_xla(A: CSR, x: torch.Tensor) -> torch.Tensor:
    """y[m] = A[m, n] @ x[n] in fp32."""
    return spmm_xla(A, x[:, None])[:, 0]


#: above this nnz the CSR dispatchers pack to ELL (once, memoized per CSR
#: instance) and run the slab kernel; below it the pack is not worth a host pass
AUTO_ELL_THRESHOLD = 1 << 18

_ELL_CACHE: dict = {}  # id(CSR) -> (weakref, ELL on some device)


def _ell_of(A: CSR, device) -> ELL:
    """Memoized ELL pack of a CSR (weakly keyed by instance), on ``device``.
    A CSR held in tensors is packed on the host as well (the device pack,
    ``ell_pack_device``, is not ported yet)."""
    key = id(A)
    ent = _ELL_CACHE.get(key)
    if ent is not None and ent[0]() is A:
        E = ent[1]
    else:
        E = ell_pack(A)
    E = E.to(device)
    _ELL_CACHE[key] = (weakref.ref(A, lambda r, k=key: _ELL_CACHE.pop(k, None)), E)
    return E


def _auto_ell(A) -> bool:
    return isinstance(A, CSR) and A.nnz >= AUTO_ELL_THRESHOLD


def _blocked_unported():
    return NotImplementedError(
        "BlockedCSR SpMM (spmm_tpu/ops/blocked.py) is not ported yet; see ROADMAP.md"
    )


def spmm(A, B: torch.Tensor, **kw) -> torch.Tensor:
    """Dispatch SpMM on the input format: ELL (K2), BSR (K1), CSR (gather +
    ``index_add_``; CSRs with nnz >= AUTO_ELL_THRESHOLD pack to ELL once and
    reuse the pack across calls)."""
    if isinstance(A, ELL):
        return ell_spmm(A, B, **kw)
    if isinstance(A, BSR):
        return bsr_spmm(A, B, **kw)
    if isinstance(A, BlockedCSR):
        raise _blocked_unported()
    if _auto_ell(A):
        return ell_spmm(_ell_of(A, B.device), B, **kw)
    return spmm_xla(A, B, **kw)


def spmv(A, x: torch.Tensor, **kw) -> torch.Tensor:
    if isinstance(A, ELL):
        return ell_spmv(A, x, **kw)
    if isinstance(A, BlockedCSR):
        raise _blocked_unported()
    if _auto_ell(A):
        return ell_spmv(_ell_of(A, x.device), x, **kw)
    return spmv_xla(A, x, **kw)
