"""K1 — BSR SpMM: the CUDA kernel ``csrc/bsr_spmm.cu``, its plain PyTorch
version, its group plan (:func:`group_plan`, built once per BSR and memoized
on it), and the wrapper that picks between kernel and plain version by the
tensors' device; beside them the BSR SpMV, plain PyTorch on every device.

Replaces the Pallas TPU kernel ``spmm_tpu/ops/pallas_bsr.py:
bsr_spmm_pallas``; ``bsr_spmm_reference`` is the counterpart of that
module's ``bsr_spmm_xla`` oracle and ``bsr_spmv`` of its ``bsr_spmv``.  The
kernel's header says what bounds it on the card and how its design answers
that.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_tpu_torch import kernels
from spmm_tpu_torch.formats.bsr import BSR
from spmm_tpu_torch.formats.containers import as_numpy, as_tensor, memo_of

#: CUDA launches of K1 in this process (chip_smoke.py resets and reads it)
launches = 0

#: output columns per CUDA block; k must be a multiple of it (as the TPU
#: kernel's k_tile, pallas_bsr.py:44-45)
K_TILE = 128
#: output rows per CUDA block: a group of ROWS // bm block rows (the
#: kernel's kRows)
ROWS = 64
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


def group_plan(block_indptr, block_cols, bm: int):
    """K1's group plan: ``G = ROWS // bm`` consecutive block rows form a group
    (one CUDA block of output rows).  Returns ``(G, gptr, ucols, blk)``, int32
    numpy: group g's block columns are ``ucols[gptr[g]:gptr[g+1]]``, sorted
    and distinct, and ``blk[u, i]`` is the index of the block of union entry
    u in the group's block row i, or -1.  Raises on a block shape the kernel
    does not take (bm > ROWS) and on two blocks at one place."""
    if not 1 <= bm <= ROWS:
        raise ValueError(f"bsr_spmm: bm={bm} must be in [1, {ROWS}]")
    G = ROWS // bm
    indptr = np.asarray(block_indptr, np.int64)
    bcols = np.asarray(block_cols, np.int64)[: indptr[-1]]
    nbrows = len(indptr) - 1
    brow = np.repeat(np.arange(nbrows, dtype=np.int64), np.diff(indptr))
    ncolb = int(bcols.max()) + 1 if len(bcols) else 1
    key = (brow // G) * ncolb + bcols
    uniq, inv = np.unique(key, return_inverse=True)
    ngroups = -(-nbrows // G)
    gptr = np.searchsorted(uniq // ncolb, np.arange(ngroups + 1), side="left")
    slot = inv.reshape(-1) * G + brow % G
    if len(np.unique(slot)) != len(slot):
        raise ValueError("bsr_spmm: two blocks share one (block row, block column)")
    blk = np.full(len(uniq) * G, -1, np.int32)
    blk[slot] = np.arange(len(slot), dtype=np.int32)
    return G, gptr.astype(np.int32), (uniq % ncolb).astype(np.int32), blk.reshape(-1, G)


def _device_plan(A: BSR, device):
    """The group plan of ``A`` on ``device``, built once and memoized on A
    (:func:`memo_of`)."""
    memo = memo_of(A, "_k1_plans")
    if device not in memo:
        G, gptr, ucols, blk = group_plan(as_numpy(A.block_indptr), as_numpy(A.block_cols),
                                         A.block_shape[0])
        memo[device] = (G, *(torch.from_numpy(a).to(device) for a in (gptr, ucols, blk)))
    return memo[device]


def bsr_spmm(A: BSR, B: torch.Tensor) -> torch.Tensor:
    """Y[m, k] = A_bsr @ B[n, k] in fp32.  B may have n or n_pad rows; k must
    be a multiple of 128.  CPU tensors take the plain version; CUDA tensors
    launch K1 (bm <= 64, data and B both fp32 or both bf16), and anything K1
    does not take raises."""
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
    dev = B.device
    data = as_tensor(A.data, dev)
    if data.dtype != B.dtype:
        raise TypeError(f"bsr_spmm: data dtype {data.dtype} differs from B dtype {B.dtype}")
    if not data.is_contiguous():
        raise ValueError("bsr_spmm: BSR data must be contiguous")
    if tuple(data.shape) != (A.nblocks, bm, bn):
        raise ValueError(f"bsr_spmm: data shape {tuple(data.shape)} != {(A.nblocks, bm, bn)}")
    G, gptr, ucols, blk = _device_plan(A, dev)
    Bp = _padded_rhs(A, B)
    if Bp.data_ptr() % 16:  # a view at an odd offset: the 16-byte copies need alignment
        Bp = Bp.clone()
    m = A.shape[0]
    Y = torch.empty((m, k), dtype=torch.float32, device=dev)
    if m == 0 or k == 0:
        return Y
    launches += 1
    err = kernels.lib().bsr_spmm_launch(
        data.data_ptr(), gptr.data_ptr(), ucols.data_ptr(), blk.data_ptr(), Bp.data_ptr(),
        Y.data_ptr(), _DTYPES[B.dtype], gptr.shape[0] - 1, G, bm, bn, k, m,
        kernels.stream_ptr(dev),
    )
    kernels.check(err, "bsr_spmm")
    return Y


def bsr_spmv(A: BSR, x: torch.Tensor, *, accum_dtype=None) -> torch.Tensor:
    """y[m] = A_bsr @ x[n] (port of ``spmm_tpu/ops/pallas_bsr.py: bsr_spmv``,
    XLA there and plain PyTorch here on every device): one (nblocks, bn)
    gather of x tiles, a batched matvec per block and an ``index_add_`` over
    block rows.  Accumulates in ``accum_dtype``, by default the promotion of
    the block dtype with fp32, so fp64 blocks stay fp64."""
    bm, bn = A.block_shape
    m = A.shape[0]
    dev = x.device
    data = as_tensor(A.data, dev)
    acc = accum_dtype or torch.promote_types(data.dtype, torch.float32)
    xt = _padded_rhs(A, x[:, None]).reshape(-1, bn)
    gx = xt.index_select(0, as_tensor(A.block_cols, dev).long()).to(acc)  # (nblocks, bn)
    prods = torch.bmm(data.to(acc), gx[:, :, None])[:, :, 0]  # (nblocks, bm)
    y = torch.zeros((A.nbrows, bm), dtype=acc, device=dev)
    y.index_add_(0, as_tensor(A.block_rows, dev).long(), prods)
    return y.reshape(A.nbrows * bm)[:m]
