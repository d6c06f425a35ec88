"""One run of one cell: set-up, the timed window, the traced window, the
comparison with the reference, and the result line.

The window is a closed loop with one caller, as a library is used: the next
call starts when the last one has returned, until ``seconds`` have passed
since the first began.  Each call is timed on the host clock from its start
until its result is in the caller's hands."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import os
import sys
import time
import warnings

import numpy as np

from portbench import trace as T
from portbench.judge import as_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
#: modules that no process of the benchmark may hold (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "spmm_tpu")
#: the longest traced window: per-call ratios need no more, and the
#: profiler's own cost (its stop and the reading of its events) grows with it
TRACE_SECONDS = 10.0


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  #: this cell's end-to-end metric entries
    per_layer: list  #: this cell's per-layer metric entries

    @property
    def kind(self):
        return importlib.import_module(f"portbench.calls.{self.traffic['call']}")


def _for_cell(metrics: list, name: str) -> list:
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def reader_of(metric: str) -> str:
    """The reader module of a per-layer metric: its name up to the first
    dot, so that one quantity split by the end-to-end metric it moves
    (``device_idle_share.spgemm``, ``device_idle_share.train``) has one
    reader."""
    return metric.split(".")[0]


def load_cell(workload: str, benchmark: dict | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``, its configuration and
    traffic files and its metrics."""
    if benchmark is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            benchmark = json.load(f)
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = {c["name"]: c for c in benchmark["configs"]}[w["config"]]
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(workload, int(w["chips"]), config, traffic,
                _for_cell(benchmark["end_to_end"], workload), _for_cell(benchmark["per_layer"], workload))


class Reservoir:
    """A uniform sample of ``size`` of the window's outputs, drawn from the
    seed (reservoir sampling): keeping one costs no copy."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.kept = size, 0, []
        self.rng = np.random.default_rng([seed, 2])

    def offer(self, out) -> None:
        i = self.seen
        self.seen += 1
        if i < self.size:
            self.kept.append((i, out))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.size:
                self.kept[j] = (i, out)


def window(kind, state, seconds: float, sample: Reservoir, traced: bool = False):
    """The timed window: ``(latencies_s, window_s)``.  A traced window marks
    itself and each call with a span of the profiler's."""
    if traced:
        from torch.profiler import record_function as span
    else:
        span = lambda name: contextlib.nullcontext()  # noqa: E731
    lat = []
    t = t0 = time.perf_counter()
    end = t0 + seconds
    with span(T.WINDOW_SPAN):
        while t < end or not lat:
            with span(T.CALL_SPAN):
                out = kind.call(state)
            t1 = time.perf_counter()
            lat.append(t1 - t)
            sample.offer(out)
            t = t1
    return lat, t - t0


def host_times() -> tuple:
    """(this process's CPU seconds, the host's stolen seconds over all its
    CPUs, from /proc/stat; 0 where it cannot be read)."""
    cpu = sum(os.times()[:2])
    try:
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        steal = 0.0
    return cpu, steal


def log(what: str, t: float) -> None:
    """A progress line on standard error: what ended, and its seconds."""
    print(f"portbench: {what} {time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """One run; returns the result line as a dict (``checks`` last).  A
    traced run's window is at most ``TRACE_SECONDS`` long, all of it traced.
    ``t_start``: the process's start on the host clock (this call's start
    when None), from which ``setup_s`` counts."""
    import torch

    if t_start is None:
        t_start = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    kind = cell.kind
    log("imports", t_start)
    t = time.perf_counter()
    state = kind.setup(cell.config, cell.traffic, seed, device)
    if cuda:
        torch.cuda.synchronize()
    log("set-up", t)
    sample = Reservoir(kind.KEEP, seed)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        seconds = min(seconds, TRACE_SECONDS)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # that a profiler keeps one cycle's events
            prof.start()
    t_window = time.perf_counter()
    host0 = host_times()
    lat, window_s = window(kind, state, seconds, sample, traced=trace)
    host1 = host_times()
    setup_s = t_window - t_start
    if cuda:
        torch.cuda.synchronize()
    if prof is not None:
        prof.stop()
    log(f"window of {len(lat)} calls", t_window)
    ms = sorted(1e3 * x for x in lat)
    print(f"portbench: call ms min {ms[0]:.3f} median {ms[len(ms) // 2]:.3f} p95 {ms[(95 * len(ms)) // 100]:.3f} "
          f"max {ms[-1]:.3f}; first {', '.join(f'{1e3 * x:.3f}' for x in lat[:3])}; process cpu "
          f"{host1[0] - host0[0]:.3f} s, host stolen {host1[1] - host0[1]:.3f} s", file=sys.stderr, flush=True)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    counts = kind.counts(state)

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    metrics, breakdown = {}, None
    if trace:
        t = time.perf_counter()
        tr = T.collect(prof, len(lat))
        del prof
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        for m in cell.per_layer:
            reader = importlib.import_module(f"portbench.metrics.{reader_of(m['name'])}")
            value = reader.read(tr, counts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = T.breakdown(tr)
        del tr
        log("trace", t)
    else:
        mean_ms = 1e3 * window_s / len(lat)
        values = {"call_ms": mean_ms, "step_ms": mean_ms, "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    t = time.perf_counter()
    kind.release(state)
    checks = kind.judge(state, sample.kept, device)
    if cuda:
        torch.cuda.synchronize()
    log("reference and comparison", t)
    kept = len(sample.kept)
    del sample
    correct = all(c.ok for c in checks) and bool(checks)
    line = {"correct": correct, "attempted": len(lat), "failed": 0 if correct else kept,
            "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = as_json(checks)
    return line


def check_lines(line: dict) -> list:
    """The compared numbers beside their limits, one line each."""
    return [f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in line["checks"].items()]


def finite(x):
    """JSON-safe: non-finite floats become None."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x
