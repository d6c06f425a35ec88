"""SpMM / SpMV — sparse × dense products (port of ``spmm_tpu/ops/spmm.py``).

- ``spmm_xla`` / ``spmv_xla``: a gather and the ordered segment sum
  (``ops/segments.py``; the counterparts of the JAX package's XLA gather +
  segment-sum paths, bit-reproducible as they are).  Correct for any CSR,
  padded or tight.
- ``spmm`` / ``spmv``: dispatchers on the input format — ELL (kernel K2), BSR
  (kernel K1), BlockedCSR (``ops/blocked.py``, K2 per v8-group bucket), CSR
  (large CSRs pack to ELL once, memoized per instance).

Every entry point sums and returns in ``accum_dtype``: fp32 by default, as
in the JAX package, whatever the stored type (bf16, fp32, fp64);
``torch.float64`` for fp64 parity, which on the card runs on the kernels
when values and B are fp64.  Gradients flow to the dense operand and to the
sparse values through every path (the kernels' through their
``torch.autograd.Function``).  ``spmm_xla`` and ``ell_spmm`` take a stack
(b, n, k) of right-hand sides, the batched form.
Containers holding numpy arrays are moved to the device of the dense operand.
"""

from __future__ import annotations

import weakref

import torch

from spmm_tpu_torch.formats.bsr import BSR
from spmm_tpu_torch.formats.containers import CSR, BlockedCSR, as_tensor
from spmm_tpu_torch.formats.ell import ELL, ell_pack, ell_pack_device
from spmm_tpu_torch.ops.blocked import blocked_spmm
from spmm_tpu_torch.ops.bsr_kernel import bsr_spmm
from spmm_tpu_torch.ops.ell_spmm import ell_spmm, ell_spmv, fold_batch, unfold_batch
from spmm_tpu_torch.ops.segments import offsets_plan, segment_sum


def _rows_plan(A: CSR, device):
    """The segments of A's rows: ``indptr``, the padded nonzeros joining the
    last row as ``boundary_segments`` puts them (data 0: no change to the
    sum, the same gradient as the JAX package's)."""
    off = as_tensor(A.indptr, device).long()
    if off.numel() > 1:
        off = torch.cat([off[:-1], off.new_full((1,), A.nnz_pad)])
    return offsets_plan(off, device)


def spmm_xla(A: CSR, B: torch.Tensor, *, accum_dtype=torch.float32) -> torch.Tensor:
    """Y[m, k] = A[m, n] @ B[n, k] via row gather + the ordered segment sum
    over the rows, summed and returned in ``accum_dtype``, the same bits on
    every run.  Padded nonzeros (data == 0) contribute nothing, so no masking
    is needed.  B may be a stack (b, n, k), returned as (b, m, k): the
    batched form (``vmap`` over B in the JAX package)."""
    B, batch = fold_batch(B)
    dev = B.device
    gathered = B.index_select(0, as_tensor(A.indices, dev).long()).to(accum_dtype)
    contrib = gathered * as_tensor(A.data, dev).to(accum_dtype)[:, None]
    return unfold_batch(segment_sum(contrib, plan=_rows_plan(A, dev)), batch)


def spmv_xla(A: CSR, x: torch.Tensor, *, accum_dtype=torch.float32) -> torch.Tensor:
    """y[m] = A[m, n] @ x[n], summed and returned in ``accum_dtype``."""
    return spmm_xla(A, x[:, None], accum_dtype=accum_dtype)[:, 0]


#: above this nnz the CSR dispatchers pack to ELL (once, memoized per CSR
#: instance) and run the slab kernel; below it the pack is not worth a host pass
AUTO_ELL_THRESHOLD = 1 << 18

_ELL_CACHE: dict = {}  # id(CSR) -> (weakref, ELL on some device)


def _ell_of(A: CSR, device) -> ELL:
    """Memoized ELL pack of a CSR (weakly keyed by instance), on ``device``.
    A numpy-held CSR packs on the host; a tensor-held one (e.g. a chained
    SpGEMM output) packs on its own device through ``ell_pack_device``, so
    no nnz-scale array crosses to the host."""
    key = id(A)
    ent = _ELL_CACHE.get(key)
    if ent is not None and ent[0]() is A:
        E = ent[1]
    elif isinstance(A.data, torch.Tensor):
        E = ell_pack_device(A)
    else:
        E = ell_pack(A)
    E = E.to(device)
    _ELL_CACHE[key] = (weakref.ref(A, lambda r, k=key: _ELL_CACHE.pop(k, None)), E)
    return E


def _auto_ell(A) -> bool:
    return isinstance(A, CSR) and A.nnz >= AUTO_ELL_THRESHOLD


def spmm(A, B: torch.Tensor, **kw) -> torch.Tensor:
    """Dispatch SpMM on the input format: ELL (K2), BSR (K1), BlockedCSR (the
    v8-slab path, K2 per bucket), CSR (gather + ordered segment sum; CSRs
    with nnz >= AUTO_ELL_THRESHOLD pack to ELL once and reuse the pack
    across calls).  Keywords pass on to the format's entry point:
    ``accum_dtype`` and the like; the BSR product takes ``k_tile`` and
    ``interpret`` (as ``bsr_spmm_pallas``) and sums in fp32, or fp64 for
    fp64 operands."""
    if isinstance(A, ELL):
        return ell_spmm(A, B, **kw)
    if isinstance(A, BSR):
        return bsr_spmm(A, B, **kw)
    if isinstance(A, BlockedCSR):
        return blocked_spmm(A, B, **kw)
    if _auto_ell(A):
        return ell_spmm(_ell_of(A, B.device), B, **kw)
    return spmm_xla(A, B, **kw)


def spmv(A, x: torch.Tensor, **kw) -> torch.Tensor:
    if isinstance(A, ELL):
        return ell_spmv(A, x, **kw)
    if isinstance(A, BlockedCSR):
        return blocked_spmm(A, x[:, None], **kw)[:, 0]
    if _auto_ell(A):
        return ell_spmv(_ell_of(A, x.device), x, **kw)
    return spmv_xla(A, x, **kw)
