"""K1 — BSR SpMM: the CUDA kernel ``csrc/bsr_spmm.cu``, its plain PyTorch
version, and the wrapper that picks between them by the tensors' device.

Replaces the Pallas TPU kernel ``spmm_tpu/ops/pallas_bsr.py:
bsr_spmm_pallas``; ``bsr_spmm_reference`` is the counterpart of that
module's ``bsr_spmm_xla`` oracle.  The kernel's header says what bounds it on
the card and how its design answers that.
"""

from __future__ import annotations

import torch

from spmm_tpu_torch import kernels
from spmm_tpu_torch.formats.bsr import BSR
from spmm_tpu_torch.formats.containers import as_tensor

#: CUDA launches of K1 in this process (chip_smoke.py resets and reads it)
launches = 0

#: output columns per CUDA block; k must be a multiple of it (as the TPU
#: kernel's k_tile, pallas_bsr.py:44-45)
K_TILE = 128
_MAX_BM = 32
_MAX_SMEM = 48 * 1024
_DTYPES = {torch.float32: kernels.F32, torch.bfloat16: kernels.BF16}


def _padded_rhs(A: BSR, B: torch.Tensor) -> torch.Tensor:
    """B with zero rows appended up to the padded block-column count."""
    bn = A.block_shape[1]
    n_pad = (A.shape[1] + bn - 1) // bn * bn
    if B.dim() != 2 or B.shape[0] > n_pad:
        raise ValueError(f"B must be (n, k) with n <= {n_pad}, got {tuple(B.shape)}")
    if B.shape[0] == n_pad:
        return B
    return torch.cat([B, B.new_zeros((n_pad - B.shape[0], B.shape[1]))])


def bsr_spmm_reference(A: BSR, B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = A @ B: gather the B tile of every block, one batched
    fp32 product, and an ``index_add_`` over block rows.  Output fp32 (m, k)."""
    bm, bn = A.block_shape
    m = A.shape[0]
    k = B.shape[-1]
    dev = B.device
    Bp = _padded_rhs(A, B).float()
    tiles = Bp.reshape(-1, bn, k).index_select(0, as_tensor(A.block_cols, dev).long())
    prods = torch.einsum("bij,bjk->bik", as_tensor(A.data, dev).float(), tiles)
    y = torch.zeros((A.nbrows, bm, k), dtype=torch.float32, device=dev)
    y.index_add_(0, as_tensor(A.block_rows, dev).long(), prods)
    return y.reshape(A.nbrows * bm, k)[:m]


def bsr_spmm(A: BSR, B: torch.Tensor) -> torch.Tensor:
    """Y[m, k] = A_bsr @ B[n, k] in fp32.  B may have n or n_pad rows; k must
    be a multiple of 128.  CPU tensors take the plain version; CUDA tensors
    launch K1, and anything K1 does not take raises."""
    global launches
    k = B.shape[-1]
    if k % K_TILE:
        raise ValueError(f"k={k} must be a multiple of {K_TILE}")
    if B.device.type == "cpu":
        return bsr_spmm_reference(A, B)
    if B.device.type != "cuda":
        raise ValueError(f"bsr_spmm: unsupported device {B.device}")
    if B.dtype not in _DTYPES:
        raise TypeError(f"bsr_spmm: B dtype {B.dtype} not supported (float32, bfloat16)")
    if not B.is_contiguous():
        raise ValueError("bsr_spmm: B must be contiguous")
    bm, bn = A.block_shape
    if not 1 <= bm <= _MAX_BM or bm * bn * 4 > _MAX_SMEM:
        raise ValueError(f"bsr_spmm: block shape {A.block_shape} not supported")
    dev = B.device
    data = as_tensor(A.data, dev)
    indptr = as_tensor(A.block_indptr, dev)
    bcols = as_tensor(A.block_cols, dev)
    if data.dtype != B.dtype:
        raise TypeError(f"bsr_spmm: data dtype {data.dtype} differs from B dtype {B.dtype}")
    if indptr.dtype != torch.int32 or bcols.dtype != torch.int32:
        raise TypeError("bsr_spmm: block_indptr and block_cols must be int32")
    if not (data.is_contiguous() and indptr.is_contiguous() and bcols.is_contiguous()):
        raise ValueError("bsr_spmm: BSR arrays must be contiguous")
    if tuple(data.shape) != (A.nblocks, bm, bn):
        raise ValueError(f"bsr_spmm: data shape {tuple(data.shape)} != {(A.nblocks, bm, bn)}")
    Bp = _padded_rhs(A, B)
    m = A.shape[0]
    Y = torch.empty((m, k), dtype=torch.float32, device=dev)
    if m == 0 or k == 0:
        return Y
    launches += 1
    err = kernels.lib().bsr_spmm_launch(
        data.data_ptr(), indptr.data_ptr(), bcols.data_ptr(), Bp.data_ptr(), Y.data_ptr(),
        _DTYPES[B.dtype], A.nbrows, bm, bn, k, m, kernels.stream_ptr(dev),
    )
    kernels.check(err, "bsr_spmm")
    return Y
