"""Primitive rates of the card (port of ``benchmarks/primitives.py``): the
rates ``ops.roofline.MeasuredRates`` charges in the ``*_attainable`` bounds.

Each primitive is measured in the form the port's own paths use it:

- batched minor-axis sort: ``torch.sort(keys, dim=1, stable=True)`` and a
  ``gather`` of one fp32 payload by its order, as ``_merge_block``
  (``ops/slab_spgemm.py``) sorts each slab chunk, at widths L = 16, 64, 128
  and 512;
- global 1-D sort: one int32 key, two payloads gathered by its order;
- row gather with uniform-random indices, by row width (W = 1, 4, 16, 128
  fp32 from a 2^20-row table) and by table size with 512 B rows and with
  32 B rows (the B2 table's rows at W = 8; the sizes straddle the 50 MB L2),
  in the three forms the port gathers rows in, the best kept:
  ``torch.index_select(table, 0, idx)`` and ``table[idx]``, which store the
  rows (``spmm_xla`` and the SpGEMM's chunk fetch), and K2
  (``ops.ell_kernel``, its CUDA kernel on the card) over rows of 8 such
  indices, which sums each row as it arrives (``ell_spmm``, ``ell_spmv``);
- scatter: atomic ``index_add_`` onto sorted segments, the port's ordered
  ``ops.segments.segment_sum`` (its CUDA kernel on the card) and
  ``index_copy_`` to sorted, unique positions (the B2 build's form); the
  best of the three is kept, since a bound is a lower bound only when its
  denominators cannot be beaten;
- ``torch.gather(dim=1)`` (printed only), a batched cumsum (8 bytes per
  element: the streaming rate) beside a plain device copy, and one launch +
  sync + scalar copy to the host.

Times come from ``utils.timing.measure_device_loop`` (CUDA events on the
card).  Run on the card:

    python -m spmm_tpu_torch.utils.primitives [--size 23] [--json]

It measures the first CUDA card and raises, exiting nonzero and writing
nothing, where there is none.  ``--json`` writes
``spmm_tpu_torch/primitive_rates_h100.json`` with the card's name and power
limit.  On the CPU, ``measure_rates(size_log2=12,
device="cpu", gather_tables_log2=(10, 12), narrow_tables_log2=(10, 12))``
runs every primitive at a tiny size; such rates are never written.
"""

from __future__ import annotations

import argparse
import datetime
import json
import statistics
import subprocess
import sys
import time

import torch

from spmm_tpu_torch.formats.containers import compute_device
from spmm_tpu_torch.ops import ell_kernel, segments
from spmm_tpu_torch.ops.roofline import MeasuredRates
from spmm_tpu_torch.utils.timing import measure_device_loop

#: log2 of the row counts of the 512 B-row tables: 16, 32, 64, 256 MB, 1 GB
GATHER_TABLES_LOG2 = (15, 16, 17, 19, 21)
#: log2 of the row counts of the 32 B-row tables: 16, 32, 64, 256, 512 MB
NARROW_TABLES_LOG2 = (19, 20, 21, 23, 24)
#: slab widths of the batched sort
SORT_WIDTHS = (16, 64, 128, 512)
#: row widths (fp32 elements) of the gather from a fixed table
GATHER_WIDTHS = (1, 4, 16, 128)


def measure_rates(size_log2: int = 23, *, device="cuda", gather_tables_log2=GATHER_TABLES_LOG2,
                  narrow_tables_log2=NARROW_TABLES_LOG2, log=print) -> dict:
    """Measures every primitive on ``device`` with 2^``size_log2`` elements
    and returns the fields of :class:`MeasuredRates` (curves as tuples of
    (size, rate) pairs).  ``log`` gets one line per measurement."""
    dev = compute_device(device)
    E = 1 << size_log2
    g = torch.Generator(device=dev).manual_seed(0)

    def ints(hi: int, shape, dtype=torch.int64):
        return torch.randint(0, hi, shape, generator=g, device=dev, dtype=dtype)

    def normal(shape):
        return torch.randn(shape, generator=g, device=dev)

    def timed(name: str, fn, consts: tuple, n: int, unit: str = "elem") -> float:
        t = measure_device_loop(lambda _c, *a: fn(*a), None, consts, name=name)
        rate = n / (t.median_ms * 1e-3)
        log(f"{name:<44} {t.median_ms:9.4f} ms  {rate / 1e6:12.1f} M {unit}/s")
        return rate

    def bsort(keys, vals):
        ks, order = torch.sort(keys, dim=1, stable=True)
        return ks, vals.gather(1, order)

    sort_curve = []
    for L in SORT_WIDTHS:
        R = max(E // L, 1)
        rate = timed(f"batched minor-axis sort L={L}", bsort, (ints(1 << 20, (R, L), torch.int32), normal((R, L))),
                     R * L)
        sort_curve.append((L, rate))

    def gsort(k, p1, p2):
        ks, order = torch.sort(k, stable=True)
        return ks, p1[order], p2[order]

    sort_global = timed("global 1-D sort (1 key + 2 payloads)", gsort,
                        (ints(1 << 30, (E,), torch.int32), ints(1 << 20, (E,), torch.int32), normal((E,))), E)

    def gather(label: str, table, n: int) -> float:
        """The best of the three forms the port gathers rows in: two that
        store every gathered row, ``index_select`` (``spmm_xla``, the
        leftover streams) and indexing ``table[idx]`` (the SpGEMM's chunk
        fetch), and K2's, where each row is summed into its output row as
        it arrives: one slab of rows of 8 uniform-random columns with unit
        values (``ell_spmm``; at W = 1, ``ell_spmv``)."""
        idx = ints(table.shape[0], (n,))
        cols = idx.to(torch.int32).view(-1, min(8, n))
        ones = torch.ones(cols.shape, device=dev)
        memo = {}  # K2's work table, built at the first (untimed) call
        rates = (
            timed(f"{label}, index_select", lambda t, i: torch.index_select(t, 0, i), (table, idx), n, "rows"),
            timed(f"{label}, table[idx]", lambda t, i: t[i], (table, idx), n, "rows"),
            timed(f"{label}, K2 (rows of 8 summed)",
                  lambda t, c, d: ell_kernel.ell_slabs_spmm((c,), (d,), t, memo=memo), (table, cols, ones), n, "rows"),
        )
        return max(rates)

    ntab = min(1 << 20, E)
    by_width = {W: gather(f"row gather width={W} ({max(E // W, 1)} rows)", normal((ntab, W)), max(E // W, 1))
                for W in GATHER_WIDTHS}

    def curve(widths_log2, W: int, label: str):
        pts = []
        for lg in widths_log2:
            table = normal((1 << lg, W))
            nbytes = table.numel() * 4
            # 2^21 gathered rows per measurement
            pts.append((nbytes, gather(f"{label} gather, {nbytes / 2**20:g} MB table", table, min(1 << 21, E))))
            del table
        return tuple(pts)

    gather_curve = curve(gather_tables_log2, 128, "512 B row")
    narrow_curve = curve(narrow_tables_log2, 8, "32 B row")

    nseg = max(E // 16, 1)
    vals = normal((E,))
    seg = ints(nseg, (E,)).sort().values
    plan = segments.segment_plan(seg, nseg, indices_are_sorted=True, device=dev)
    scatter_add = timed("scatter-add index_add_ (atomic, sorted ids)",
                        lambda v, s: torch.zeros(nseg, device=dev).index_add_(0, s, v), (vals, seg), E)
    scatter_ordered = timed("ordered segment_sum (sorted ids)", lambda v: segments.segment_sum(v, plan=plan),
                            (vals,), E)
    ES = max(E // 2, 1)
    pos = torch.randperm(E, generator=g, device=dev)[:ES].sort().values
    scatter_set = timed("index_copy_ to sorted unique positions",
                        lambda p, v: torch.zeros(E, dtype=torch.int32, device=dev).index_copy_(0, p, v),
                        (pos, ints(1000, (ES,), torch.int32)), ES)

    R = max(E // 128, 1)
    v2 = normal((R, 128))
    timed("take_along_axis (gather dim=1)", lambda v, i: torch.gather(v, 1, i), (v2, ints(128, (R, 128))), R * 128)
    cumsum_rate = timed("batched cumsum (R, 128)", lambda v: torch.cumsum(v, dim=1), (v2,), R * 128)
    copy_rate = timed("device copy (R, 128)", lambda v: v.clone(), (v2,), R * 128)
    log(f"{'streaming rates':<44} cumsum {cumsum_rate * 8 / 1e9:.1f} GB/s, copy {copy_rate * 8 / 1e9:.1f} GB/s "
        "(8 B per element: read + write)")

    one = torch.ones(8, device=dev)
    torch.add(one, 1.0)[0].item()
    fences = []
    for _ in range(12):
        t0 = time.perf_counter()
        torch.add(one, 1.0)[0].item()
        fences.append(time.perf_counter() - t0)
    dispatch = statistics.median(fences)
    log(f"{'dispatch + sync + scalar D2H':<44} {dispatch * 1e6:9.1f} us")

    return {
        "row_gather_rows_s": max(by_width.values()),
        "scatter_elems_s": max(scatter_add, scatter_ordered, scatter_set),
        "scalar_gather_s": by_width[1],
        "sort_batched_s": max(r for _, r in sort_curve),
        "sort_batched_curve": tuple(sort_curve),
        "sort_global_s": sort_global,
        # a cumsum reads and writes 8 B per element: the streaming byte rate
        "elementwise_gbs": cumsum_rate * 8,
        "row_gather_curve": gather_curve,
        "row_gather_narrow_curve": narrow_curve,
        "dispatch_fence_s": dispatch,
    }


def _power_limit(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card ``dev``, asked for
    by its UUID, which names the same card whatever ``CUDA_VISIBLE_DEVICES``
    holds."""
    uuid = str(torch.cuda.get_device_properties(dev).uuid)
    uuid = uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"  # nvidia-smi's form
    out = subprocess.run(["nvidia-smi", "-i", uuid, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=23, help="log2 of the element count")
    ap.add_argument("--json", action="store_true",
                    help="write spmm_tpu_torch/primitive_rates_h100.json, the file MeasuredRates.load() "
                         "reads (on a CUDA card only)")
    args = ap.parse_args(argv)
    dev = compute_device("cuda")  # raises without a card: rates of any other device are never written
    rates = measure_rates(args.size, device=dev)
    MeasuredRates(**rates)  # every field there
    if args.json:
        out = dict(rates)
        out.update(
            _device=torch.cuda.get_device_name(dev),
            _power_limit=_power_limit(dev),
            _captured=datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
            _size_log2=args.size,
            _torch=torch.__version__,
            _cuda=torch.version.cuda,
        )
        path = MeasuredRates.calibration_path()
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
