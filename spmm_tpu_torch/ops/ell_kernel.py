"""K2 — one ELL slab times a dense matrix: the CUDA kernel
``csrc/ell_slab_spmm.cu``, its plain PyTorch version, and the wrapper that
picks between them by the tensors' device.

Replaces the Pallas TPU kernel ``spmm_tpu/ops/pallas_ell.py:
ell_slab_octets_pallas`` (reached by ``ell_slab_spmm_pallas``) and the XLA
per-slab sum of ``spmm_tpu/ops/ell_spmm.py: _slab_loop``.  The kernel's header
says what bounds it on the card and how its design answers that.
"""

from __future__ import annotations

import torch

from spmm_tpu_torch import kernels

#: CUDA launches of K2 in this process (chip_smoke.py resets and reads it)
launches = 0

_DTYPES = {torch.float32: kernels.F32, torch.bfloat16: kernels.BF16}


def ell_slab_spmm_reference(cols: torch.Tensor, data: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``Y[r] = Σ_e data[r, e] · B[clip(cols[r, e]), :]`` in
    fp32, for cols/data (R, L) and B (n, k)."""
    c = cols.long().clamp(0, B.shape[0] - 1)
    return (data.float()[..., None] * B[c].float()).sum(1)


def _check_cuda(cols, data, B, out) -> None:
    dev = B.device
    for name, t in (("cols", cols), ("data", data), ("out", out)):
        if t.device != dev:
            raise ValueError(f"ell_slab_spmm: {name} on {t.device}, B on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"ell_slab_spmm: {name} must be contiguous")
    if not B.is_contiguous():
        raise ValueError("ell_slab_spmm: B must be contiguous")
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_slab_spmm: cols must be int32, got {cols.dtype}")
    if data.dtype not in _DTYPES or B.dtype not in _DTYPES:
        raise TypeError(
            f"ell_slab_spmm: data {data.dtype} / B {B.dtype} not supported (float32, bfloat16)"
        )
    if out.dtype != torch.float32:
        raise TypeError(f"ell_slab_spmm: out must be float32, got {out.dtype}")
    if data.shape != cols.shape:
        raise ValueError(f"ell_slab_spmm: data {tuple(data.shape)} != cols {tuple(cols.shape)}")
    if cols.shape[1] < 1 or B.shape[0] < 1:
        raise ValueError("ell_slab_spmm: needs L >= 1 and n >= 1")


def ell_slab_spmm(
    cols: torch.Tensor, data: torch.Tensor, B: torch.Tensor, *, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Y (R, k) fp32 for one (R, L) slab; written into ``out`` (an (R, k)
    fp32 tensor, e.g. a row range of the sorted output) when given.  CPU
    tensors take the plain version; CUDA tensors launch K2, and anything K2
    does not take raises."""
    global launches
    if cols.dim() != 2 or B.dim() != 2:
        raise ValueError("ell_slab_spmm: cols must be (R, L) and B (n, k)")
    R = cols.shape[0]
    k = B.shape[1]
    if out is None:
        out = torch.empty((R, k), dtype=torch.float32, device=B.device)
    elif tuple(out.shape) != (R, k):
        raise ValueError(f"ell_slab_spmm: out {tuple(out.shape)} != {(R, k)}")
    if B.device.type == "cpu":
        return out.copy_(ell_slab_spmm_reference(cols, data, B))
    if B.device.type != "cuda":
        raise ValueError(f"ell_slab_spmm: unsupported device {B.device}")
    _check_cuda(cols, data, B, out)
    if R == 0 or k == 0:
        return out
    launches += 1
    err = kernels.lib().ell_slab_spmm_launch(
        cols.data_ptr(), data.data_ptr(), _DTYPES[data.dtype], B.data_ptr(), _DTYPES[B.dtype],
        out.data_ptr(), R, cols.shape[1], B.shape[0], k, kernels.stream_ptr(B.device),
    )
    kernels.check(err, "ell_slab_spmm")
    return out
