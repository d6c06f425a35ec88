"""The config-5 cell (``webgraph-10m.spgemm-fresh``): its entries in
``BENCHMARK.json``, the readers of the piece route's spans on hand-made
traces, and the tiny fresh traffic run through the piece route on the CPU
(``_MAX_EXP_PAD`` cut so that the tiny graph takes it)."""

import importlib

import numpy as np
import pytest
from pytest import approx

from portbench import harness
from portbench.tests.conftest import BENCHMARK, tiny_cell
from portbench.trace import CALL_SPAN, Trace

CELL = "webgraph-10m.spgemm-fresh"
BIG_METRICS = {"spgemm_big_split_ms": "spmm.spgemm.big.split", "spgemm_big_piece_ms": "spmm.spgemm.big.piece",
               "spgemm_big_stitch_ms": "spmm.spgemm.big.stitch"}
#: the whole-A sizing and the pieces' landings, read in this cell by the
#: web-Google cells' readers under a name of its own
SPLIT_METRICS = {"spgemm_sizing_ms.big": "spgemm_sizing_ms", "spgemm_to_host_ms.big": "spgemm_to_host_ms"}


def _trace(host, calls=2):
    a = lambda i: np.array([h[i] for h in host], np.int64)
    return Trace(
        t0=0, t1=1000, calls=calls,
        dev_start=np.array([10], np.int64), dev_end=np.array([20], np.int64), dev_kind=["kernel"], dev_name=["k"],
        host_start=a(0), host_end=a(1), host_thread=a(2), host_name=[h[3] for h in host],
    )


def _read(name, tr):
    return importlib.import_module(f"portbench.metrics.{name}").read(tr, {})


#: two calls: the first takes two split rounds and three pieces, the second one round and two pieces
BIG = _trace([
    (0, 500, 1, CALL_SPAN), (0, 490, 1, "spmm.spgemm"), (10, 20, 1, "spmm.spgemm.sizing"),
    (20, 480, 1, "spmm.spgemm.big"), (20, 50, 1, "spmm.spgemm.big.split"), (50, 70, 1, "spmm.spgemm.big.split"),
    (70, 170, 1, "spmm.spgemm.big.piece"), (170, 270, 1, "spmm.spgemm.big.piece"),
    (270, 370, 1, "spmm.spgemm.big.piece"), (370, 480, 1, "spmm.spgemm.big.stitch"),
    (500, 1000, 1, CALL_SPAN), (500, 990, 1, "spmm.spgemm"), (510, 980, 1, "spmm.spgemm.big"),
    (510, 540, 1, "spmm.spgemm.big.split"), (540, 700, 1, "spmm.spgemm.big.piece"),
    (700, 850, 1, "spmm.spgemm.big.piece"), (850, 980, 1, "spmm.spgemm.big.stitch"),
])


def test_the_cell_and_its_metrics_are_declared():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic == {"call": "spgemm", "operands": "fresh", "values": "normal"}
    assert cell.config["generator"] == {"name": "webgraph_like", "n": 10_000_000, "nnz": 104_600_000,
                                        "locality": 0.6, "zipf_a": 2.72, "empty_frac": 0.044, "seed": 5}
    entries = {m["name"]: m for m in BENCHMARK["per_layer"] + BENCHMARK["end_to_end"]}
    for name in ("call_ms", "spgemm_kernels_roofline", "spgemm_d2h_ms", "device_idle_share.spgemm"):
        assert CELL in entries[name]["workloads"]
    for name in list(BIG_METRICS) + list(SPLIT_METRICS):
        m = entries[name]
        assert CELL in m["workloads"] and m["moves"] == "call_ms" and m["source"] == "device_trace"
        assert m["unit"] == "ms" and m["better"] == "lower"
    for name, whole in SPLIT_METRICS.items():
        assert entries[name]["layer"] == entries[whole]["layer"] and harness.reader_of(name) == whole
    assert {m["name"] for m in cell.per_layer} >= set(BIG_METRICS) | set(SPLIT_METRICS)


@pytest.mark.parametrize("name", sorted(BIG_METRICS))
def test_the_route_readers_sum_their_spans_a_call(name):
    want = {"spgemm_big_split_ms": 30 + 20 + 30, "spgemm_big_piece_ms": 100 * 3 + 160 + 150,
            "spgemm_big_stitch_ms": 110 + 130}[name]
    assert _read(name, BIG) == approx(1e-6 * want / 2)


@pytest.mark.parametrize("name", sorted(BIG_METRICS))
def test_a_program_without_the_route_spans_reads_none(name):
    """The parent of the spans, or a product that never takes the route,
    records none of them: the reader returns None and the line leaves the
    metric out."""
    bare = _trace([(0, 500, 1, CALL_SPAN), (0, 490, 1, "spmm.spgemm"), (10, 20, 1, "spmm.spgemm.sizing"),
                   (500, 1000, 1, CALL_SPAN), (20, 60, 1, "aten::copy_")])
    assert _read(name, bare) is None


@pytest.mark.parametrize("trace", [0, 1])
def test_the_tiny_fresh_traffic_runs_correct_through_the_piece_route(trace, monkeypatch):
    """With the budget cut, every call of the tiny fresh traffic (the two
    warm-up calls and the window's) takes the piece route, and the run is
    correct; traced, the route's readers find their spans."""
    from spmm_tpu_torch.ops import slab_spgemm as ss

    monkeypatch.setattr(ss, "_MAX_EXP_PAD", 1 << 16)
    cell = tiny_cell("spgemm-fresh")
    cell = harness.Cell(cell.name, 1, cell.config, cell.traffic, cell.end_to_end, harness.load_cell(CELL).per_layer)
    before = ss.big_products
    line = harness.run_cell(cell, 2**31 + 13, 0.3, bool(trace), "cpu")
    assert line["correct"], line["checks"]
    assert ss.big_products - before == line["attempted"] + 2
    if trace:
        for name in list(BIG_METRICS) + list(SPLIT_METRICS):
            assert line["metrics"][name]["value"] > 0 and line["metrics"][name]["unit"] == "ms"
    else:
        assert set(line["metrics"]) == {"call_ms", "setup_s"}
