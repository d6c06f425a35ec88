"""K1 — BSR SpMM: the CUDA kernel ``csrc/bsr_spmm.cu``, its plain PyTorch
version, its group plan (:func:`group_plan`, built once per BSR and memoized
on it), and the wrapper that picks between kernel and plain version by the
tensors' device; beside them the BSR SpMV, plain PyTorch on every device.

Gradients.  K1 launches through ctypes, which autograd cannot see, so on CUDA
tensors a product whose B or block values require grad goes through a
``torch.autograd.Function``: grad B = Aᵀ · dY is the transposed kernel of
``csrc/bsr_spmm.cu``, which reads A's blocks where they are stored, after a
plan that groups them by block column (:func:`transposed_plan`, built once
per BSR and memoized); grad data, ``dData[b] = dY[rows of b] · B[cols of
b]ᵀ``, is one ``torch.bmm`` over gathered tiles (a batched dense product,
which no TPU kernel computes either).  CPU tensors take the plain version,
which autograd differentiates as it stands.

Types.  The blocks and B may be fp32 and bf16 in any mix (the sums and the
output fp32), or both fp64 (fp64 sums and output).

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
from spmm_tpu_torch.ops.ell_kernel import grad_needed
from spmm_tpu_torch.ops.segments import (
    offsets_plan,
    segment_plan,
    segment_sum,
    segment_sum_reference,
)

#: CUDA launches in this process (chip_smoke.py resets and reads them): K1,
#: and the transposed kernel (grad B)
launches = 0
transposed_launches = 0

#: output columns per CUDA block; k must be a multiple of it (as the TPU
#: kernel's k_tile, pallas_bsr.py:44-45)
K_TILE = 128
#: output rows per CUDA block: a group of ROWS // bm block rows (the
#: kernel's kRows)
ROWS = 64
#: output rows per CUDA block of the transposed kernel (its kRowsT): ROWS_T //
#: bn block columns, or a part of one block column when bn > ROWS_T
ROWS_T = 128
_DTYPES = {torch.float32: kernels.F32, torch.bfloat16: kernels.BF16, torch.float64: kernels.F64}


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
    product in the promotion of the block dtype with fp32, and an
    ``index_add_`` over block rows.  Output (m, k) in that type."""
    bm, bn = A.block_shape
    m = A.shape[0]
    k = B.shape[-1]
    dev = B.device
    data = as_tensor(A.data, dev)
    acc = torch.promote_types(data.dtype, torch.float32)
    Bp = _padded_rhs(A, B).to(acc)
    tiles = Bp.reshape(-1, bn, k).index_select(0, as_tensor(A.block_cols, dev).long())
    prods = torch.einsum("bij,bjk->bik", data.to(acc), tiles)
    y = torch.zeros((A.nbrows, bm, k), dtype=acc, device=dev)
    y.index_add_(0, as_tensor(A.block_rows, dev).long(), prods)
    return y.reshape(A.nbrows * bm, k)[:m]


def group_plan(block_indptr, block_cols, bm: int, rows: int = ROWS):
    """K1's group plan: ``G = rows // bm`` consecutive block rows form a group
    (one CUDA block of output rows).  Returns ``(G, gptr, ucols, blk)``, int32
    numpy: group g's block columns are ``ucols[gptr[g]:gptr[g+1]]``, sorted
    and distinct, and ``blk[u, i]`` is the index of the block of union entry
    u in the group's block row i, or -1.  Raises on a block shape the kernel
    does not take (bm > rows) and on two blocks at one place."""
    if not 1 <= bm <= rows:
        raise ValueError(f"bsr_spmm: bm={bm} must be in [1, {rows}]")
    G = rows // bm
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


def _acc_of(name: str, data_dtype, b_dtype):
    """The sums' (and output's) type of blocks ``data_dtype`` times a dense
    ``b_dtype`` on the card; raises on a pair the kernels are not built for."""
    if {data_dtype, b_dtype} <= {torch.float32, torch.bfloat16}:
        return torch.float32
    if data_dtype == b_dtype == torch.float64:
        return torch.float64
    raise TypeError(f"{name}: blocks {data_dtype} with B {b_dtype}: the kernel takes float32 and "
                    "bfloat16 in any mix, or float64 for both")


def _check_blocks(name: str, A: BSR, data: torch.Tensor) -> None:
    bm, bn = A.block_shape
    if not data.is_contiguous():
        raise ValueError(f"{name}: BSR data must be contiguous")
    if tuple(data.shape) != (A.nblocks, bm, bn):
        raise ValueError(f"{name}: data shape {tuple(data.shape)} != {(A.nblocks, bm, bn)}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when it starts off a 16-byte boundary (a view
    at an odd offset): the kernels' 16-byte copies need alignment."""
    return t.clone() if t.data_ptr() % 16 else t


def _k1_launch(A: BSR, data: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """One launch of K1: the blocks ``data`` laid out as ``A`` (whose group
    plan is memoized on it) times B."""
    global launches
    k = B.shape[-1]
    if k % K_TILE:
        raise ValueError(f"k={k} must be a multiple of {K_TILE}")
    acc = _acc_of("bsr_spmm", data.dtype, B.dtype)
    if not B.is_contiguous():
        raise ValueError("bsr_spmm: B must be contiguous")
    _check_blocks("bsr_spmm", A, data)
    bm, bn = A.block_shape
    dev = B.device
    G, gptr, ucols, blk = _device_plan(A, dev)
    Bp = _aligned(_padded_rhs(A, B))
    m = A.shape[0]
    Y = torch.empty((m, k), dtype=acc, device=dev)
    if m == 0 or k == 0:
        return Y
    launches += 1
    err = kernels.lib().bsr_spmm_launch(
        data.data_ptr(), gptr.data_ptr(), ucols.data_ptr(), blk.data_ptr(), Bp.data_ptr(),
        Y.data_ptr(), _DTYPES[data.dtype], _DTYPES[B.dtype], gptr.shape[0] - 1, G, bm, bn, k, m,
        kernels.stream_ptr(dev),
    )
    kernels.check(err, "bsr_spmm")
    return Y


def bsr_spmm(A: BSR, B: torch.Tensor, *, k_tile: int = K_TILE, interpret: bool = False) -> torch.Tensor:
    """Y[m, k] = A_bsr @ B[n, k] in fp32 (fp64 for fp64 operands).  B may have
    n or n_pad rows; k must be a multiple of ``k_tile`` (a multiple of 128,
    as ``bsr_spmm_pallas`` takes it; the kernel's own tile stays 128
    columns).  ``interpret`` is the Pallas switch and is ignored.  CPU tensors
    take the plain version; CUDA tensors launch K1 (bm <= 64; blocks and B
    fp32 / bf16 in any mix, or both fp64), and anything K1 does not take
    raises.  When B or the block values require grad, the CUDA product is
    recorded for autograd (its backward: the transposed kernel, a
    ``torch.bmm``)."""
    del interpret
    k = B.shape[-1]
    if k_tile < K_TILE or k_tile % K_TILE:
        raise ValueError(f"k_tile={k_tile} must be a multiple of {K_TILE}")
    if k % k_tile:  # bsr_spmm_pallas's message, and the kernel's own tile beside it
        raise ValueError(f"k={k} must be a multiple of k_tile={k_tile} (a multiple of {K_TILE})")
    if B.device.type == "cpu":
        return bsr_spmm_reference(A, B)
    if B.device.type != "cuda":
        raise ValueError(f"bsr_spmm: unsupported device {B.device}")
    data = as_tensor(A.data, B.device)
    if grad_needed(B, data):
        return _BsrSpmm.apply(B, data, A)
    return _k1_launch(A, data, B)


class _BsrSpmm(torch.autograd.Function):
    """K1 with its backward: grad B through the transposed kernel, grad data
    through one batched dense product; only what ``needs_input_grad`` asks
    for is computed."""

    @staticmethod
    def forward(ctx, B, data, A):
        ctx.A = A
        ctx.save_for_backward(B, data)
        return _k1_launch(A, data, B)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dY):
        B, data = ctx.saved_tensors
        A = ctx.A
        dY = dY.contiguous()
        gB = gdata = None
        if ctx.needs_input_grad[0]:
            gB = bsr_spmm_transposed(A, dY, data=data).to(B.dtype)
            if B.shape[0] > gB.shape[0]:  # B came with its padding rows
                gB = torch.cat([gB, gB.new_zeros((B.shape[0] - gB.shape[0], gB.shape[1]))])
        if ctx.needs_input_grad[1]:
            gdata = bsr_data_grad(A, dY, B).to(data.dtype)
        return gB, gdata, None


def bsr_data_grad(A: BSR, dY: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``dData[b] = dY[rows of b] · B[cols of b]ᵀ`` (nblocks, bm, bn): the
    gradient of ``A_bsr @ B`` with respect to the block values, as one
    ``torch.bmm`` over gathered tiles, in dY's dtype, on every device."""
    bm, bn = A.block_shape
    dev, k = dY.device, dY.shape[1]
    pad = A.nbrows * bm - dY.shape[0]
    if pad:
        dY = torch.cat([dY, dY.new_zeros((pad, k))])
    yt = dY.reshape(A.nbrows, bm, k).index_select(0, as_tensor(A.block_rows, dev).long())
    bt = _padded_rhs(A, B).to(dY.dtype).reshape(-1, bn, k).index_select(
        0, as_tensor(A.block_cols, dev).long())
    return torch.bmm(yt, bt.transpose(1, 2))


def transposed_plan(block_rows, block_cols, n_bcols: int, bm: int, bn: int):
    """The transposed kernel's plan: A's blocks grouped by block column, as
    :func:`group_plan` groups them by block row.  Returns ``(G, nsub, gptr,
    ucols, blk)``, int32 numpy: ``G = ROWS_T // bn`` block columns form a
    group (one when bn > ROWS_T, each then cut into ``nsub`` parts of
    ROWS_T rows); group g's block rows are ``ucols[gptr[g]:gptr[g+1]]``,
    sorted and distinct, and ``blk[u, i]`` is the index in A of the block
    at union entry u and the group's block column i, or -1 -- indices to
    A's blocks, no copy of values."""
    brows = np.asarray(block_rows, np.int64)
    bcols = np.asarray(block_cols, np.int64)[: len(brows)]
    order = np.lexsort((brows, bcols))  # by block column, then block row
    indptr = np.concatenate([[0], np.cumsum(np.bincount(bcols, minlength=n_bcols))])
    G, gptr, ucols, blk = group_plan(indptr, brows[order], min(bn, ROWS_T), rows=ROWS_T)
    blk = np.where(blk >= 0, order[np.maximum(blk, 0)], -1).astype(np.int32)
    return G, -(-bn // ROWS_T), gptr, ucols, blk


def _device_transposed_plan(A: BSR, device):
    """:func:`transposed_plan` of ``A`` on ``device``, built once and
    memoized on A."""
    memo = memo_of(A, "_k1t_plans")
    if device not in memo:
        bm, bn = A.block_shape
        G, nsub, *arrays = transposed_plan(as_numpy(A.block_rows), as_numpy(A.block_cols),
                                           -(-A.shape[1] // bn), bm, bn)
        memo[device] = (G, nsub, *(torch.from_numpy(a).to(device) for a in arrays))
    return memo[device]


def bsr_spmm_transposed_reference(A: BSR, dY: torch.Tensor, *,
                                  data: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch (n, k) = Aᵀ · dY from A's own blocks: each block
    transposed times its dY rows (one batched product), then the ordered sum
    of the products by block column (:func:`segment_sum_reference`), on
    every device.  Sums and returns in fp64 when either operand is fp64, else
    fp32."""
    bm, bn = A.block_shape
    n = A.shape[1]
    dev, k = dY.device, dY.shape[1]
    data = as_tensor(A.data if data is None else data, dev)
    acc = torch.promote_types(torch.promote_types(data.dtype, dY.dtype), torch.float32)
    rows = A.nbrows * bm
    dYp = dY[:rows] if dY.shape[0] >= rows else torch.cat([dY, dY.new_zeros((rows - dY.shape[0], k))])
    tiles = dYp.to(acc).reshape(A.nbrows, bm, k).index_select(0, as_tensor(A.block_rows, dev).long())
    prods = torch.einsum("bij,bik->bjk", data.to(acc), tiles)  # (nblocks, bn, k)
    nbc = -(-n // bn)
    plan = segment_plan(as_tensor(A.block_cols, dev), nbc)
    g = segment_sum_reference(prods.reshape(A.nblocks, bn * k), plan)
    return g.reshape(nbc * bn, k)[:n]


def bsr_spmm_transposed(A: BSR, dY: torch.Tensor, *, data: torch.Tensor | None = None) -> torch.Tensor:
    """(n, k) = Aᵀ · dY for dY (m, k): the gradient of :func:`bsr_spmm` with
    respect to B.  On CUDA tensors ONE launch of the transposed kernel, which
    reads the block values (``data``, by default ``A.data``) where they are
    stored, so learnable values are always current; its plan is memoized on
    A.  CPU tensors take the plain version."""
    global transposed_launches
    dev = dY.device
    if dev.type == "cpu":
        return bsr_spmm_transposed_reference(A, dY, data=data)
    if dev.type != "cuda":
        raise ValueError(f"bsr_spmm_transposed: unsupported device {dev}")
    data = as_tensor(A.data if data is None else data, dev)
    acc = _acc_of("bsr_spmm_transposed", data.dtype, dY.dtype)
    k = dY.shape[1]
    if dY.dim() != 2 or k % K_TILE:
        raise ValueError(f"bsr_spmm_transposed: dY must be (m, k) with k a multiple of {K_TILE}")
    _check_blocks("bsr_spmm_transposed", A, data)
    dY = _aligned(dY.contiguous())
    bm, bn = A.block_shape
    n = A.shape[1]
    G, nsub, gptr, ucols, blk = _device_transposed_plan(A, dev)
    Y = torch.empty((n, k), dtype=acc, device=dev)
    if n == 0 or k == 0:
        return Y
    vec_a = int((bn * data.element_size()) % 16 == 0 and data.data_ptr() % 16 == 0)
    transposed_launches += 1
    err = kernels.lib().bsr_spmm_t_launch(
        data.data_ptr(), gptr.data_ptr(), ucols.data_ptr(), blk.data_ptr(), dY.data_ptr(),
        Y.data_ptr(), _DTYPES[data.dtype], _DTYPES[dY.dtype], gptr.shape[0] - 1, nsub, G, bm, bn,
        k, dY.shape[0], n, vec_a, kernels.stream_ptr(dev),
    )
    kernels.check(err, "bsr_spmm_transposed")
    return Y


def bsr_spmv(A: BSR, x: torch.Tensor, *, accum_dtype=None) -> torch.Tensor:
    """y[m] = A_bsr @ x[n] (port of ``spmm_tpu/ops/pallas_bsr.py: bsr_spmv``,
    XLA there and PyTorch here): one (nblocks, bn) gather of x tiles, a
    batched matvec per block and the ordered sum over block rows
    (:func:`segment_sum`: the same bits on every run).  Accumulates in
    ``accum_dtype``, by default the promotion of the block dtype with fp32,
    so fp64 blocks stay fp64."""
    bm, bn = A.block_shape
    m = A.shape[0]
    dev = x.device
    data = as_tensor(A.data, dev)
    acc = accum_dtype or torch.promote_types(data.dtype, torch.float32)
    xt = _padded_rhs(A, x[:, None]).reshape(-1, bn)
    gx = xt.index_select(0, as_tensor(A.block_cols, dev).long()).to(acc)  # (nblocks, bn)
    prods = torch.bmm(data.to(acc), gx[:, :, None])[:, :, 0]  # (nblocks, bm)
    y = segment_sum(prods, plan=offsets_plan(A.block_indptr, dev))
    return y.reshape(A.nbrows * bm)[:m]
