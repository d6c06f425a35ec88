"""Speed-of-light bounds for the kernels (port of the datasheet half of
``spmm_tpu/ops/roofline.py``).

Each op gets an analytic lower bound on its time from (a) the bytes it must
move -- each input read once, each output written once -- at the card's
memory rate and (b) its operations at the card's peak rate for their type;
the larger of the two is the bound, and achieved / bound the efficiency.
Sparse products at web-graph densities are bandwidth-bound.

The JAX package's ``MeasuredRates`` / ``*_attainable`` functions are fits to
primitive rates measured on a TPU; their counterpart waits for a rates file
measured on the H100 and no number of theirs is carried over.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float  # device-memory bandwidth, GB/s
    flops_f32: float  # peak fp32 FLOP/s outside the tensor cores
    flops_bf16: float  # peak dense bf16 FLOP/s (tensor cores)
    flops_f64: float = 0.0  # peak fp64 FLOP/s outside the tensor cores
    flops_f64_tensor: float = 0.0  # peak dense fp64 FLOP/s in the tensor cores (DMMA, exact fp64)
    flops_tf32: float = 0.0  # peak dense tf32 FLOP/s (tensor cores)
    l2_bytes: int = 0


#: NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 Tensor Core GPU datasheet
#: (dense rates, at the full 700 W power limit): 3.35 TB/s HBM3, 67 TFLOP/s
#: fp32 and 34 TFLOP/s fp64 outside the tensor cores ("FP32", "FP64"), 989
#: TFLOP/s bf16, 495 TFLOP/s tf32 and 67 TFLOP/s fp64 in them ("BFLOAT16 /
#: TF32 / FP64 Tensor Core"), 50 MB L2
H100_SXM = ChipSpec("h100-sxm", hbm_gbps=3350.0, flops_f32=67e12, flops_bf16=989e12,
                    flops_f64=34e12, flops_f64_tensor=67e12, flops_tf32=495e12,
                    l2_bytes=50 * 1000 * 1000)


def detect_chip(device="cuda") -> ChipSpec:
    """The datasheet entry of the card behind ``device`` (raises without a
    CUDA device).  Only the H100 has an entry: for another card, or for a
    CPU, give the roofline functions a ``ChipSpec`` of its own."""
    import torch

    from spmm_tpu_torch.formats.containers import compute_device

    dev = compute_device(device)
    if dev.type == "cpu":
        raise ValueError("no datasheet entry for a CPU: pass chip=ChipSpec(...) with its rates")
    name = torch.cuda.get_device_name(dev)
    if "H100" in name:
        return H100_SXM
    raise ValueError(f"no datasheet entry for {name!r}: pass chip=ChipSpec(...)")


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops: float
    hbm_bytes: float
    chip: ChipSpec
    #: the peak FLOP/s of the operations' type; the chip's fp32 rate when None
    peak_flops: float | None = None

    @property
    def t_bandwidth_s(self) -> float:
        return self.hbm_bytes / (self.chip.hbm_gbps * 1e9)

    @property
    def t_compute_s(self) -> float:
        return self.flops / (self.peak_flops or self.chip.flops_f32)

    @property
    def t_sol_s(self) -> float:
        return max(self.t_bandwidth_s, self.t_compute_s)

    @property
    def bound_by(self) -> str:
        """What sets the bound: "bytes" or "operations"."""
        return "bytes" if self.t_bandwidth_s >= self.t_compute_s else "operations"

    def efficiency(self, measured_s: float) -> float:
        return self.t_sol_s / max(measured_s, 1e-12)


def spmm_roofline(nnz: int, m: int, n: int, k: int, *, bytes_val=4, bytes_idx=4,
                  b_reuse: float = 1.0, chip: ChipSpec | None = None) -> Roofline:
    """A(m×n, nnz) @ B(n×k).  ``b_reuse``: average times each touched B row is
    re-read from device memory (1.0 = every row once; nnz/distinct-cols =
    no reuse)."""
    chip = chip or detect_chip()
    flops = 2.0 * nnz * k
    distinct = min(nnz, n)
    bytes_ = (
        nnz * (bytes_val + bytes_idx)  # A
        + distinct * k * bytes_val * b_reuse  # B rows
        + m * k * bytes_val  # Y
    )
    return Roofline(flops=flops, hbm_bytes=bytes_, chip=chip)


def spmv_roofline(nnz: int, m: int, n: int, **kw) -> Roofline:
    return spmm_roofline(nnz, m, n, 1, **kw)


def spgemm_roofline(expand: int, nnz_a: int, nnz_b: int, nnz_out: int, *,
                    bytes_val=4, bytes_idx=4, chip: ChipSpec | None = None) -> Roofline:
    """ESC SpGEMM: ``expand`` partial products (= FLOPs/2).

    Problem-intrinsic bound (algorithm-independent): read A and B once,
    materialize + re-read the expanded (col, val) stream once each way (any
    ESC formulation moves at least the 8 B/slot expansion through device
    memory twice), write C once.  Deliberately does NOT model the sort's own
    passes — the kernel must earn them."""
    chip = chip or detect_chip()
    flops = 2.0 * expand
    slot_bytes = bytes_idx + bytes_val
    bytes_ = (
        nnz_a * (bytes_val + bytes_idx)
        + nnz_b * (bytes_val + bytes_idx)
        + expand * slot_bytes * 2
        + nnz_out * (bytes_val + 2 * bytes_idx)
    )
    return Roofline(flops=flops, hbm_bytes=bytes_, chip=chip)
