"""The readers of the program's spans (``portbench/spans.py`` and the five
per-layer metrics built on it) on hand-made traces, and on a traced CPU run
of the tiny repeat traffic, where the program records its spans too."""

import importlib

import numpy as np
from pytest import approx

from portbench import harness
from portbench.spans import host_events, ms_per_call
from portbench.tests.conftest import BENCHMARK, tiny_cell
from portbench.trace import CALL_SPAN, Trace

SPAN_METRICS = ["spgemm_sizing_ms", "spgemm_plan_lookup_ms", "spgemm_plan_hit_share", "spgemm_to_host_ms",
                "spmm_host_ms"]


def _trace(host, calls=2):
    """A window of ``calls`` calls over 0 .. 1000 ns with the host events
    ``(start, end, thread, name)`` and one kernel."""
    a = lambda i: np.array([h[i] for h in host], np.int64)
    return Trace(
        t0=0, t1=1000, calls=calls,
        dev_start=np.array([10], np.int64), dev_end=np.array([20], np.int64), dev_kind=["kernel"], dev_name=["k"],
        host_start=a(0), host_end=a(1), host_thread=a(2), host_name=[h[3] for h in host],
    )


def _read(name, tr):
    return importlib.import_module(f"portbench.metrics.{name}").read(tr, {})


SPGEMM = _trace([
    (0, 500, 1, CALL_SPAN), (0, 490, 1, "spmm.spgemm"), (10, 110, 1, "spmm.spgemm.sizing"),
    (110, 130, 1, "spmm.spgemm.plan_lookup"), (130, 131, 1, "spmm.spgemm.plan_hit"),
    (300, 480, 1, "spmm.spgemm.to_host"),
    (500, 1000, 1, CALL_SPAN), (500, 990, 1, "spmm.spgemm"), (510, 570, 1, "spmm.spgemm.sizing"),
    (570, 580, 1, "spmm.spgemm.plan_lookup"), (800, 960, 1, "spmm.spgemm.to_host"),
])
TRAIN = _trace([
    (0, 300, 1, CALL_SPAN), (0, 40, 1, "spmm.ell_spmm"), (100, 160, 2, "spmm.ell.transposed"),
    (160, 190, 2, "spmm.ell.sddmm"), (300, 600, 1, CALL_SPAN), (300, 330, 1, "spmm.ell_spmm"),
    (400, 450, 7, "spmm.ell.transposed"), (450, 470, 7, "spmm.ell.sddmm"), (600, 1000, 1, CALL_SPAN),
    (600, 620, 1, "spmm.ell_spmm"), (700, 720, 2, "autograd::engine::evaluate_function: x"),
], calls=3)


def test_the_helper_sums_and_counts_by_name():
    assert host_events(SPGEMM, ("spmm.spgemm.sizing",)) == (160, 2)
    assert host_events(SPGEMM, ("spmm.spgemm.sizing", "spmm.spgemm.plan_lookup")) == (190, 4)
    assert host_events(SPGEMM, ("spmm.absent",)) == (0, 0)
    assert ms_per_call(SPGEMM, "spmm.absent") is None
    assert ms_per_call(SPGEMM, "spmm.spgemm.to_host") == approx(1e-6 * 340 / 2)


def test_spgemm_readers():
    assert _read("spgemm_sizing_ms", SPGEMM) == approx(1e-6 * 160 / 2)
    assert _read("spgemm_plan_lookup_ms", SPGEMM) == approx(1e-6 * 30 / 2)
    assert _read("spgemm_plan_hit_share", SPGEMM) == approx(50.0)
    assert _read("spgemm_to_host_ms", SPGEMM) == approx(1e-6 * 340 / 2)


def test_the_training_reader_sums_every_thread():
    """Backward runs on autograd's threads: their spans count beside the
    forward's."""
    assert _read("spmm_host_ms", TRAIN) == approx(1e-6 * (40 + 30 + 20 + 60 + 30 + 50 + 20) / 3)


def test_a_program_without_spans_reads_none():
    """The parent of the spans records none: every reader returns None, so
    the line leaves the metric out; a hit share of 0 needs the program's
    spans."""
    bare = _trace([(0, 500, 1, CALL_SPAN), (500, 1000, 1, CALL_SPAN), (20, 60, 1, "aten::copy_")])
    assert all(_read(name, bare) is None for name in SPAN_METRICS)
    misses = _trace([(0, 1000, 1, CALL_SPAN), (0, 990, 1, "spmm.spgemm")], calls=1)
    assert _read("spgemm_plan_hit_share", misses) == 0.0
    assert _read("spgemm_plan_lookup_ms", misses) is None


def test_each_metric_is_read_in_exactly_its_cells():
    entries = {m["name"]: m for m in BENCHMARK["per_layer"]}
    repeat, fresh, train = "web-google.spgemm-repeat", "web-google.spgemm-fresh", "web-google.spmm-train-k128"
    want = {"spgemm_sizing_ms": {fresh, repeat}, "spgemm_plan_lookup_ms": {repeat},
            "spgemm_plan_hit_share": {repeat}, "spgemm_to_host_ms": {fresh, repeat}, "spmm_host_ms": {train}}
    for name, cells in want.items():
        assert set(entries[name]["workloads"]) == cells and entries[name]["source"] == "device_trace"


def test_a_traced_cpu_run_reads_the_programs_spans(monkeypatch):
    """The tiny repeat traffic, traced on the CPU with its cell's metrics and
    the plan cache open to its small graph: the span readers find the
    program's spans, and every call hits the plan built in set-up."""
    from spmm_tpu_torch.ops import slab_spgemm

    monkeypatch.setattr(slab_spgemm, "AUTO_PLAN_MIN_NNZ", 1)
    cell = tiny_cell("spgemm-repeat")
    per_layer = harness.load_cell("web-google.spgemm-repeat").per_layer
    cell = harness.Cell(cell.name, 1, cell.config, cell.traffic, cell.end_to_end, per_layer)
    line = harness.run_cell(cell, 7, 0.3, True, "cpu")
    assert line["correct"], line["checks"]
    metrics = line["metrics"]
    assert metrics["spgemm_plan_hit_share"]["value"] == approx(100.0)
    for name in ("spgemm_sizing_ms", "spgemm_plan_lookup_ms", "spgemm_to_host_ms"):
        assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "ms"
    assert "spgemm_d2h_ms" not in metrics  # no device events on the CPU
