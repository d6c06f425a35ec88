"""Speed-of-light bounds for the kernels (port of ``spmm_tpu/ops/roofline.py``).

Two yardsticks.  The datasheet one: each op gets an analytic lower bound on
its time from (a) the bytes it must move -- each input read once, each
output written once -- at the card's memory rate and (b) its operations at
the card's peak rate for their type; the larger of the two is the bound, and
achieved / bound the efficiency.  Sparse products at web-graph densities are
bandwidth-bound.

The algorithm-aware one (``MeasuredRates`` and the four ``*_attainable``
functions): each primitive a gather/sort-formulated product cannot avoid is
charged at the rate the card was measured to run it at, by
``python -m spmm_tpu_torch.utils.primitives --json`` on the card, which
writes ``spmm_tpu_torch/primitive_rates_h100.json``.  Only that file feeds
them: the rates have no defaults, and a missing or unreadable file raises.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os


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
    CUDA device).  Only the H100 SXM has an entry ("NVIDIA H100 80GB HBM3",
    or a name with "SXM"): the PCIe and NVL cards have other memory rates
    and power limits, and for them, another card or a CPU, give the
    roofline functions a ``ChipSpec`` of its own."""
    import torch

    from spmm_tpu_torch.formats.containers import compute_device

    dev = compute_device(device)
    if dev.type == "cpu":
        raise ValueError("no datasheet entry for a CPU: pass chip=ChipSpec(...) with its rates")
    name = torch.cuda.get_device_name(dev)
    sxm = "SXM" in name or "HBM3" in name
    if "H100" in name and sxm and "PCIe" not in name and "NVL" not in name:
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


#: the command that measures the rates on the card and writes the file
PROBE_COMMAND = "python -m spmm_tpu_torch.utils.primitives --json"
#: how the names of CUDA cards begin (``torch.cuda.get_device_name``)
_CUDA_NAMES = ("NVIDIA", "Tesla", "Quadro", "GeForce", "TITAN")
_CURVES = ("sort_batched_curve", "row_gather_curve", "row_gather_narrow_curve")


def _positive(path: str, name: str, v) -> float:
    """``v`` as a float, or a ValueError naming the field: a rate is a
    finite number above 0."""
    x = float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else math.nan
    if not (math.isfinite(x) and x > 0):
        raise ValueError(f"{path}: {name} = {v!r} is not a positive finite number")
    return x


def _loglog(curve, x: float | None, fallback: float) -> float:
    """The rate of ``curve`` ((x, rate), ...) at ``x``: log-log interpolation
    between the measured points, clamped at the ends; ``fallback`` when
    ``x`` or the curve is empty."""
    if not x or not curve:
        return fallback
    pts = sorted((float(a), float(r)) for a, r in curve)
    if x <= pts[0][0]:
        return pts[0][1]
    if x >= pts[-1][0]:
        return pts[-1][1]
    lx = math.log(x)
    for (a0, r0), (a1, r1) in zip(pts, pts[1:]):
        if x <= a1:
            f = (lx - math.log(a0)) / (math.log(a1) - math.log(a0))
            return math.exp((1 - f) * math.log(r0) + f * math.log(r1))
    return pts[-1][1]


@dataclasses.dataclass(frozen=True, kw_only=True)
class MeasuredRates:
    """Primitive rates measured on the card -- the second, algorithm-aware
    bound.  The datasheet roofline assumes peak streaming, but a product
    built on gathers, sorts and scatters cannot beat the rates at which the
    card runs those primitives, however well it streams.  The
    ``*_attainable`` functions count each product's irreducible primitive
    calls at these rates.

    One source: ``python -m spmm_tpu_torch.utils.primitives --json``, run on
    the card, writes ``spmm_tpu_torch/primitive_rates_h100.json``, which
    :meth:`load` reads.  No field has a measured default: every rate is
    given or loaded, and only the curves may be left empty.

    A share above 1 (bound / measured time) is no measurement error: the
    gather rates are taken with uniform-random indices, and a product whose
    accesses have locality (a web graph's targets, rows served from the 50
    MB L2) can beat them.  A share above 1 can also mean that the probe
    measured a slower form of a primitive than the product uses.

    Each gather rate is the best of three forms (``utils.primitives``):
    ``index_select`` and ``table[idx]``, which store the gathered rows, and
    K2 (``ops.ell_kernel``), which sums each row into its output as it
    arrives.  K2's form is the fastest, so the gather rates are K2's own on
    uniform-random indices, and K2's attainable share measures the locality
    of its indices, not the quality of the kernel: a slower K2 re-probed
    slows its bound with it."""

    #: rows/s of the fastest row gather from the probe's 2^20-row tables,
    #: over the widths 1, 4, 16 and 128 fp32: the 4 B rows of width 1 in
    #: K2's summing form; charged when no table size is given
    row_gather_rows_s: float
    scatter_elems_s: float  # best of index_add_, the ordered segment sum, index_copy_
    #: gathers/s of single fp32 elements (width 1), the best form: K2's
    scalar_gather_s: float
    sort_batched_s: float  # torch.sort(dim=1) + a payload gather, best width
    #: batched-sort rate against the slab WIDTH: ((L, elems_s), ...); the
    #: warm and chain bounds charge each chunk at its own width's rate
    sort_batched_curve: tuple = ()
    sort_global_s: float  # torch.sort of one int32 key + two payload gathers
    elementwise_gbs: float  # bytes/s of a streaming pass (8 x the batched cumsum rate)
    #: row-gather rate of 512 B rows against TABLE size: ((table_bytes,
    #: rows_s), ...), the best form at each size (K2's); the sizes straddle
    #: the 50 MB L2
    row_gather_curve: tuple = ()
    #: the same with NARROW (32 B) rows; ``row_bytes <= 64`` selects it
    row_gather_narrow_curve: tuple = ()
    #: one launch of a tiny op + stream sync + a scalar copy to the host, s
    #: (microseconds on a local card)
    dispatch_fence_s: float

    def sort_rate(self, width: float | None = None) -> float:
        """Width-matched batched-sort rate: log-log interpolation of the
        calibration curve at slab width ``width``, clamped at the measured
        ends; the best-width scalar when no curve was captured."""
        return _loglog(self.sort_batched_curve, width, self.sort_batched_s)

    def row_gather_rate(self, table_bytes: float | None = None,
                        row_bytes: float | None = None) -> float:
        """Size-matched row-gather rate: log-log interpolation of the
        calibration curve at ``table_bytes``, clamped at the measured ends;
        the single-size scalar when no curve was captured.  ``row_bytes``
        <= 64 selects the narrow-row curve when there is one."""
        curve = self.row_gather_curve
        if row_bytes is not None and row_bytes <= 64 and self.row_gather_narrow_curve:
            curve = self.row_gather_narrow_curve
        return _loglog(curve, table_bytes, self.row_gather_rows_s)

    @staticmethod
    def calibration_path() -> str:
        """``spmm_tpu_torch/primitive_rates_h100.json``, shipped with the package."""
        return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "primitive_rates_h100.json")

    @classmethod
    def load(cls, path: str | None = None) -> "MeasuredRates":
        """The rates of ``path`` (default :meth:`calibration_path`).  Raises
        FileNotFoundError when there is no file, and ValueError for a file
        that is no JSON object or that :meth:`parse` refuses: nothing falls
        back to rates of another device."""
        p = path or cls.calibration_path()
        if not os.path.exists(p):
            raise FileNotFoundError(f"no primitive rates file at {p}: measure the card's rates "
                                    f"and write it with `{PROBE_COMMAND}` on the card")
        try:
            with open(p) as f:
                raw = json.load(f)
        except ValueError as e:  # json.JSONDecodeError, UnicodeDecodeError
            raise ValueError(f"{p}: not a rates file ({e})") from e
        return cls.parse(raw, p)

    @classmethod
    def parse(cls, raw, source: str = "rates") -> "MeasuredRates":
        """The rates of a rates file's parsed JSON ``raw`` (``source`` names
        it in errors).  Raises ValueError when ``raw`` is no dict, lacks a
        field, holds a rate that is not a positive number, or has a
        ``_device`` that is not a CUDA card's name."""
        if not isinstance(raw, dict):
            raise ValueError(f"{source}: not a rates file (a JSON object is expected)")
        device = raw.get("_device")
        if not isinstance(device, str) or not device.startswith(_CUDA_NAMES):
            raise ValueError(f"{source}: _device {device!r} is not the name of a CUDA card; "
                             f"these rates must be measured on the card with `{PROBE_COMMAND}`")
        kw = {}
        for field in dataclasses.fields(cls):
            name = field.name
            if name not in raw:
                raise ValueError(f"{source}: the field {name} is missing")
            v = raw[name]
            if name in _CURVES:
                if not isinstance(v, list) or not all(isinstance(pt, list) and len(pt) == 2 for pt in v):
                    raise ValueError(f"{source}: {name} is not a list of [size, rate] pairs")
                kw[name] = tuple((_positive(source, name, a), _positive(source, name, r)) for a, r in v)
            else:
                kw[name] = _positive(source, name, v)
        return cls(**kw)


@functools.cache
def _measured() -> MeasuredRates:
    """The rates file, read once, on the first bound asked for without rates."""
    return MeasuredRates.load()


def spmm_attainable(nnz_padded_rows: int, m: int, k: int,
                    rates: MeasuredRates | None = None,
                    *, table_bytes: float | None = None) -> float:
    """Attainable seconds for gather-formulated SpMM (K2): one B-row gather
    per (padded) slot + streaming the (m, k) output.  ``table_bytes``: size
    of the gathered B (n*k*4), since the gather rate depends on the table's
    size (see ``MeasuredRates.row_gather_curve``); rows of k*4 >= 128 bytes
    are charged at the wide (512 B) curve."""
    rates = rates or _measured()
    return nnz_padded_rows / rates.row_gather_rate(table_bytes, row_bytes=512) + (
        2.0 * m * k * 4
    ) / rates.elementwise_gbs


def spmv_attainable(nnz_padded: int, rates: MeasuredRates | None = None) -> float:
    """Attainable seconds for gather-formulated SpMV: one scalar x-gather
    per (padded) slot."""
    rates = rates or _measured()
    return nnz_padded / rates.scalar_gather_s


def spgemm_attainable(npa: int, slots: int, nnz_b: int, nnz_a: int | None = None,
                      rates: MeasuredRates | None = None,
                      *, nrow_b: int | None = None,
                      b2_table_bytes: float | None = None,
                      geom_table_bytes: float | None = None,
                      b2_row_bytes: float = 512.0,
                      geom_row_bytes: float = 8.0,
                      out_nnz: int | None = None,
                      dispatches: float = 1,
                      chunk_slots=None) -> float:
    """Attainable seconds for the irreducible primitives of the cold slab
    SpGEMM (``ops/slab_spgemm.py``), each at its measured, size-matched rate:

    - one B2 row gather per pa (an (A nonzero, B segment) pair) from the
      (nsegB_pad, W) int32 table of ``b2_table_bytes``: ``_chunk_fetch``'s
      ``b2_cols[b2r]``.  On the port its rows are W*4 bytes (32 B at W = 8),
      so a caller passes ``b2_row_bytes=W*4``, which selects the narrow
      curve.  The default of 512 is the TPU's folded (X, 128) granule, kept
      so that both packages take the same arguments.  The curve's rates
      are K2's summing gather (see :class:`MeasuredRates`), a form that the
      port's storing ``b2_cols[b2r]`` does not reach: the term is what a
      kernel consuming each row as it arrives would take, so the bound
      stays a lower one;
    - one B-row geometry gather per A nonzero, from the table of
      ``geom_table_bytes`` (``_plan_tables``' per-row segment counts, 8 B
      int64 rows: the narrow curve, at K2's summing rate as above);
    - three scatters: nnz(B) elements into the B2 table (its
      ``index_copy_``), nnz(A) for the pa list and nrow(B) for the
      segment offsets;
    - the two batched row sorts of ``_merge_block`` over the padded slots
      (``torch.sort(dim=1)`` each), per chunk at its width's rate when
      ``chunk_slots`` ((L, slots at L), ...) is given;
    - the stream that cannot be avoided: the pa table written once (4 B per
      pa) and the merged output written once (8 B per output nonzero);
    - ``dispatches`` x the measured launch + sync + scalar copy.

    Left out: the mask, iota and run-detection passes, which a fused
    implementation need not make, so the bound stays a lower envelope of
    this algorithm class.  ``nnz_a=None`` means nnz_b (the A×A workload)."""
    rates = rates or _measured()
    if nnz_a is None:
        nnz_a = nnz_b
    stream_bytes = 4.0 * npa + (8.0 * out_nnz if out_nnz else 0.0)
    if chunk_slots:
        sort_s = 2.0 * sum(s / rates.sort_rate(L) for L, s in chunk_slots)
    else:
        sort_s = 2.0 * slots / rates.sort_batched_s
    return (
        npa / rates.row_gather_rate(b2_table_bytes, row_bytes=b2_row_bytes)
        + nnz_a / rates.row_gather_rate(geom_table_bytes, row_bytes=geom_row_bytes)
        + sort_s
        + (nnz_b + nnz_a + (nrow_b or 0)) / rates.scatter_elems_s
        + stream_bytes / rates.elementwise_gbs
        + dispatches * rates.dispatch_fence_s
    )


def spgemm_warm_attainable(slots: int, out_nnz: int,
                           rates: MeasuredRates | None = None,
                           *, dispatches: float = 1,
                           chunk_slots=None) -> float:
    """Attainable seconds for the numeric phase on a plan with its aligned
    cache (``spgemm_slab_device(A, B, plan=plan)``, and per product of
    ``spgemm_chain_device``): the gathers ran when the plan was built, so
    what remains is ``_merge_block``'s two batched row sorts over the cached
    slots, one read of the cache and one write of the merged output, and
    ``dispatches`` x the launch + sync + scalar copy (1/n per product of a
    chain of n with one sync).  ``chunk_slots``: ((L, slots at L), ...),
    each chunk's sorts charged at its width's rate."""
    rates = rates or _measured()
    stream_bytes = 4.0 * slots + 8.0 * out_nnz
    if chunk_slots:
        sort_s = 2.0 * sum(s / rates.sort_rate(L) for L, s in chunk_slots)
    else:
        sort_s = 2.0 * slots / rates.sort_batched_s
    return (
        sort_s
        + stream_bytes / rates.elementwise_gbs
        + dispatches * rates.dispatch_fence_s
    )


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
