"""K1 — BSR SpMM: the CUDA kernel ``csrc/bsr_spmm.cu``, its plain PyTorch
version, its group plan (:func:`group_plan`, built once per BSR and memoized
on it), and the wrapper that picks between kernel and plain version by the
tensors' device; beside them the BSR SpMV, plain PyTorch on every device.

Gradients.  K1 launches through ctypes, which autograd cannot see, so on CUDA
tensors a product whose B or block values require grad goes through a
``torch.autograd.Function``: grad B = Aᵀ · dY is K1 itself on Aᵀ re-blocked
at A's block shape (:func:`transposed_bsr`, structure built once per BSR and
memoized; the block values are carried into it per call by one gather), and
grad data, ``dData[b] = dY[rows of b] · B[cols of b]ᵀ``, is one ``torch.bmm``
over gathered tiles (a batched dense product, which no TPU kernel computes
either).  CPU tensors take the plain version, which autograd differentiates
as it stands.

Types.  The sums are fp32 for fp32 / bf16 operands and fp64 for fp64 ones
(the promotion of the block dtype with fp32); the output has that type.

Replaces the Pallas TPU kernel ``spmm_tpu/ops/pallas_bsr.py:
bsr_spmm_pallas``; ``bsr_spmm_reference`` is the counterpart of that
module's ``bsr_spmm_xla`` oracle and ``bsr_spmv`` of its ``bsr_spmv``.  The
kernel's header says what bounds it on the card and how its design answers
that.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmm_tpu_torch import kernels
from spmm_tpu_torch.formats.bsr import BSR
from spmm_tpu_torch.formats.containers import as_numpy, as_tensor, memo_of
from spmm_tpu_torch.ops.ell_kernel import grad_needed

#: CUDA launches of K1 in this process (chip_smoke.py resets and reads them):
#: in all, and on a transposed BSR (the grad-B launches among them)
launches = 0
transposed_launches = 0

#: output columns per CUDA block; k must be a multiple of it (as the TPU
#: kernel's k_tile, pallas_bsr.py:44-45)
K_TILE = 128
#: output rows per CUDA block: a group of ROWS // bm block rows (the
#: kernel's kRows)
ROWS = 64
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


def _k1_launch(A: BSR, data: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """One launch of K1: the blocks ``data`` laid out as ``A`` (whose group
    plan is memoized on it) times B."""
    global launches
    k = B.shape[-1]
    if k % K_TILE:
        raise ValueError(f"k={k} must be a multiple of {K_TILE}")
    if B.dtype not in _DTYPES:
        raise TypeError(f"bsr_spmm: B dtype {B.dtype} not supported (float32, bfloat16, float64)")
    if not B.is_contiguous():
        raise ValueError("bsr_spmm: B must be contiguous")
    bm, bn = A.block_shape
    dev = B.device
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
    Y = torch.empty((m, k), dtype=torch.promote_types(B.dtype, torch.float32), device=dev)
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


def bsr_spmm(A: BSR, B: torch.Tensor) -> torch.Tensor:
    """Y[m, k] = A_bsr @ B[n, k] in fp32 (fp64 for fp64 operands).  B may have
    n or n_pad rows; k must be a multiple of 128.  CPU tensors take the plain
    version; CUDA tensors launch K1 (bm <= 64, data and B of one dtype:
    fp32, bf16 or fp64), and anything K1 does not take raises.  When B or
    the block values require grad, the CUDA product is recorded for autograd
    (its backward: K1 on the transposed BSR, a ``torch.bmm``)."""
    k = B.shape[-1]
    if k % K_TILE:
        raise ValueError(f"k={k} must be a multiple of {K_TILE}")
    if B.device.type == "cpu":
        return bsr_spmm_reference(A, B)
    if B.device.type != "cuda":
        raise ValueError(f"bsr_spmm: unsupported device {B.device}")
    data = as_tensor(A.data, B.device)
    if grad_needed(B, data):
        return _BsrSpmm.apply(B, data, A)
    return _k1_launch(A, data, B)


class _BsrSpmm(torch.autograd.Function):
    """K1 with its backward: grad B through K1 on the transposed BSR, grad
    data through one batched dense product; only what ``needs_input_grad``
    asks for is computed."""

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
            # K1 takes operands of one dtype: bf16 blocks meet a bf16 dY
            gB = bsr_spmm_transposed(A, dY.to(data.dtype), data=data).to(B.dtype)
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


def transposed_bsr(A: BSR, device=None):
    """``(T, gather)``: Aᵀ re-blocked at A's own block shape, structure only
    (transposing each block in place would give (bn, bm) blocks, which K1
    does not take).  ``T`` is a BSR of shape (n, m) whose ``data`` is
    ``gather`` (nblocks_T, bm, bn) int32: for each entry of Aᵀ's blocks, 1 +
    the flat index of the entry of ``A.data`` it carries, or 0 where Aᵀ's
    block covers nothing stored.  Entries of A's blocks past A's own shape
    (the padding of the last block row and column) are left out.  Built with
    torch ops on ``device`` (by default where ``A.block_cols`` lies) and
    memoized on A."""
    dev = torch.device(device) if device is not None else (
        A.block_cols.device if isinstance(A.block_cols, torch.Tensor) else torch.device("cpu"))
    memo = memo_of(A, "_k1_transposed")
    if dev in memo:
        return memo[dev]
    bm, bn = A.block_shape
    m, n = A.shape
    nbc_t = -(-m // bn)  # block columns of Aᵀ
    I = as_tensor(A.block_rows, dev).long()
    J = as_tensor(A.block_cols, dev).long()
    t_row = J[:, None] * bn + torch.arange(bn, device=dev)[None, :]  # (nblocks, bn): row in Aᵀ
    t_col = I[:, None] * bm + torch.arange(bm, device=dev)[None, :]  # (nblocks, bm): column in Aᵀ
    keep = ((t_col < m)[:, :, None] & (t_row < n)[:, None, :]).reshape(-1)
    key = ((t_row // bm)[:, None, :] * nbc_t + (t_col // bn)[:, :, None]).reshape(-1)[keep]
    within = ((t_row % bm)[:, None, :] * bn + (t_col % bn)[:, :, None]).reshape(-1)[keep]
    src = torch.arange(A.nblocks * bm * bn, device=dev)[keep] + 1
    uniq, inv = torch.unique(key, return_inverse=True)  # sorted: block row, then block column
    if A.nblocks * bm * bn >= 2**31 - 1:
        raise ValueError("transposed_bsr: more than 2^31 stored block entries")
    gather = torch.zeros((uniq.numel(), bm, bn), dtype=torch.int32, device=dev)
    gather.view(-1)[inv * (bm * bn) + within] = src.to(torch.int32)
    t_brow = uniq // nbc_t
    nbrows_t = -(-n // bm)
    indptr = torch.zeros(nbrows_t + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(t_brow, minlength=nbrows_t), 0)
    T = BSR(data=gather, block_cols=(uniq % nbc_t).to(torch.int32), block_rows=t_brow.to(torch.int32),
            block_indptr=indptr.to(torch.int32), shape=(n, m), block_shape=(bm, bn),
            nblocks=int(uniq.numel()), nnz=A.nnz)
    memo[dev] = (T, gather)
    return memo[dev]


def _transposed_operand(A: BSR, data, dev):
    """``(T, t_data)``: the transposed BSR of A on ``dev`` (memoized, with
    K1's group plan on it) and the block values ``data`` (by default
    ``A.data``) gathered into its layout."""
    data = as_tensor(A.data if data is None else data, dev)
    T, gather = transposed_bsr(A, dev)
    t_data = torch.cat([data.new_zeros(1), data.reshape(-1)]).index_select(
        0, gather.reshape(-1)).view(gather.shape)
    return T, t_data


def bsr_spmm_transposed_reference(A: BSR, dY: torch.Tensor, *,
                                  data: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch (n, k) = Aᵀ · dY: K1's plain version over the same
    transposed BSR as :func:`bsr_spmm_transposed`, on every device."""
    T, t_data = _transposed_operand(A, data, dY.device)
    return bsr_spmm_reference(dataclasses.replace(T, data=t_data), dY)


def bsr_spmm_transposed(A: BSR, dY: torch.Tensor, *, data: torch.Tensor | None = None) -> torch.Tensor:
    """(n, k) = Aᵀ · dY for dY (m, k): the gradient of :func:`bsr_spmm` with
    respect to B.  The block values (``data``, by default ``A.data``) are
    gathered into the transposed BSR's layout on every call, so learnable
    values stay current; then K1 on CUDA tensors (dY of the blocks' dtype),
    its plain version on CPU tensors."""
    global transposed_launches
    dev = dY.device
    if dev.type == "cpu":
        return bsr_spmm_transposed_reference(A, dY, data=data)
    if dev.type != "cuda":
        raise ValueError(f"bsr_spmm_transposed: unsupported device {dev}")
    T, t_data = _transposed_operand(A, data, dev)
    before = launches
    out = _k1_launch(T, t_data, dY)
    transposed_launches += launches - before
    return out


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
