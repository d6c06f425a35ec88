"""The graph-transformer cell (``ogbn-products.gt-train``): its reference
against a dense autograd model at small sizes, in blocks and whole; its
least-bytes count; its readers on hand-made traces and on a traced CPU run
of the tiny traffic, where the program records its attention spans."""

import importlib
import math

import numpy as np
import pytest
import torch
from pytest import approx

from portbench import harness
from portbench.counts import attention as nbytes
from portbench.counts.peaks import HBM_BYTES_PER_S
from portbench.reference.graph_transformer import loss_of, param_names, train_step
from portbench.tests.conftest import BENCHMARK, tiny_cell
from portbench.trace import CALL_SPAN, Trace

CELL = "ogbn-products.gt-train"
METRICS = ["attn_kernels_roofline", "attn_host_ms", "device_idle_share.attn"]
SPANS = ["spmm.attn.scores", "spmm.attn.softmax", "spmm.attn.scores_bwd", "spmm.attn.softmax_bwd"]


def _dense_step(mask, X, params, labels, train, heads, head_dim):
    """The same step on a dense adjacency ``mask`` (row i attends to the j
    where it is set), by autograd: a row with no entry aggregates to 0."""
    n = X.shape[0]
    layers = (len(params) - 2) // 8
    lin = lambda x, name: x @ params[name + ".weight"].t() + params[name + ".bias"]  # noqa: E731
    x = X.double()
    for i in range(layers):
        q, k, v = (lin(x, f"layers.{i}.{m}").view(n, heads, head_dim) for m in ("lin_query", "lin_key", "lin_value"))
        s = torch.einsum("ihd,jhd->hij", q, k) / math.sqrt(head_dim)
        a = torch.softmax(s.masked_fill(~mask, -math.inf), -1).nan_to_num(0.0)
        x = torch.einsum("hij,jhd->ihd", a, v).reshape(n, -1) + lin(x, f"layers.{i}.lin_skip")
        if i + 1 < layers:
            x = torch.relu(x)
    logits = lin(x, "head")
    return logits, loss_of(logits, labels, train)


@pytest.mark.parametrize("block", [1 << 18, 7])
def test_reference_matches_dense_autograd(block):
    rng = np.random.default_rng(3)
    n, heads, head_dim, classes = 60, 2, 3, 4
    mask = torch.from_numpy(rng.random((n, n)) < 0.12)
    mask[5] = False  # an empty row
    mask[9, :50] = True  # a long one
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(mask.sum(1).numpy())]).astype(np.int32))
    indices = torch.from_numpy(np.nonzero(mask.numpy())[1].astype(np.int32))
    g = torch.Generator().manual_seed(4)
    shapes = {}
    for i, fin in enumerate((5, heads * head_dim)):
        for m in ("lin_query", "lin_key", "lin_value", "lin_skip"):
            shapes[f"layers.{i}.{m}.weight"], shapes[f"layers.{i}.{m}.bias"] = (heads * head_dim, fin), (heads * head_dim,)
    shapes["head.weight"], shapes["head.bias"] = (classes, heads * head_dim), (classes,)
    assert list(shapes) == param_names(2)
    params = {name: 0.5 * torch.randn(s, generator=g, dtype=torch.float64) for name, s in shapes.items()}
    X = torch.randn(n, 5, generator=g)
    labels, train = torch.randint(0, classes, (n,), generator=g), torch.arange(1, n, 2)
    r = train_step(indptr, indices, X, params, labels, train, heads=heads, head_dim=head_dim, block=block)
    leaves = {name: p.clone().requires_grad_() for name, p in params.items()}
    logits, loss = _dense_step(mask, X, leaves, labels, train, heads, head_dim)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.testing.assert_close(r["loss"], loss.detach())
    torch.testing.assert_close(r["logits"], logits.detach())
    top = max(float(gd.abs().max()) for gd in grads)
    for name, gd in zip(leaves, grads, strict=True):
        assert float((r["grads"][name] - gd).abs().max()) <= 1e-10 * top, name
        assert bool((r["grad_scales"][name] >= r["grads"][name].abs() * (1 - 1e-12)).all()), name
    low = train_step(indptr, indices, X, params, labels, train, heads=heads, head_dim=head_dim, block=block,
                     dtype=torch.bfloat16)
    assert float((low["logits"] - r["logits"]).abs().max()) > 1e-4 * float(r["logits"].abs().max())


def test_least_bytes_grow_by_each_sparse_operations_bytes_an_entry():
    """One more entry adds its structure (4 bytes) to each of the six sparse
    products of a layer (the scores, the aggregation and, in the backward,
    dα, dV, dQ and dK) and its H values to each of them, to the softmax (2H)
    and to its backward (3H), 4 bytes a value."""
    kw = dict(layers=3, in_features=100, heads=4, head_dim=64, classes=47, train_nodes=10, col_rows=90,
              row_rows=80)
    for heads in (1, 4):
        kw["heads"] = heads
        grow = nbytes.step(100, 501, **kw) - nbytes.step(100, 500, **kw)
        assert grow == 3 * (6 * 4 + (6 + 2 + 3) * heads * 4)


def _trace(host, kernels=((10, 20),), calls=2):
    a = lambda v: np.array(v, np.int64)  # noqa: E731
    return Trace(
        t0=0, t1=1000, calls=calls,
        dev_start=a([k[0] for k in kernels]), dev_end=a([k[1] for k in kernels]),
        dev_kind=["kernel"] * len(kernels), dev_name=["k"] * len(kernels),
        host_start=a([h[0] for h in host]), host_end=a([h[1] for h in host]),
        host_thread=a([h[2] for h in host]), host_name=[h[3] for h in host],
    )


def _read(name, tr, counts=None):
    return importlib.import_module(f"portbench.metrics.{harness.reader_of(name)}").read(tr, counts or {})


def test_the_new_metrics_are_read_in_exactly_the_new_cell():
    entries = {m["name"]: m for m in BENCHMARK["per_layer"]}
    for name in METRICS:
        m = entries[name]
        assert m["workloads"] == [CELL] and m["moves"] == "step_ms" and m["source"] == "device_trace"
    assert CELL in next(m for m in BENCHMARK["end_to_end"] if m["name"] == "step_ms")["workloads"]
    assert {m["name"] for m in harness.load_cell(CELL).per_layer} == set(METRICS)


def test_the_readers_on_hand_made_traces():
    """The spans of every thread are summed a call, less the time their
    threads spend inside CUDA runtime and driver calls there (counted once
    where two overlap); without the program's spans or its count the readers
    give nothing, not 0."""
    tr = _trace([(0, 500, 1, CALL_SPAN), (10, 40, 1, SPANS[0]), (40, 60, 1, SPANS[1]), (100, 150, 2, SPANS[3]),
                 (150, 230, 2, SPANS[2]), (500, 1000, 1, CALL_SPAN), (510, 530, 1, SPANS[0]),
                 (600, 620, 1, "spmm.ell_spmm")])
    assert _read("attn_host_ms", tr) == approx(1e-6 * (30 + 20 + 50 + 80 + 20) / 2)
    waits = [(15, 25, 1, "cudaLaunchKernel"), (20, 28, 1, "Command Buffer Full"), (45, 47, 1, "cuLaunchKernel"),
             (160, 170, 2, "cudaMemcpyAsync"), (16, 18, 2, "cudaLaunchKernel"), (610, 615, 1, "cudaLaunchKernel"),
             (120, 130, 2, "aten::mul")]
    tr = _trace([(0, 500, 1, CALL_SPAN), (10, 40, 1, SPANS[0]), (40, 60, 1, SPANS[1]), (100, 150, 2, SPANS[3]),
                 (150, 230, 2, SPANS[2]), (500, 1000, 1, CALL_SPAN), (510, 530, 1, SPANS[0]),
                 (600, 620, 1, "spmm.ell_spmm"), *waits])
    assert _read("attn_host_ms", tr) == approx(1e-6 * (30 + 20 + 50 + 80 + 20 - 13 - 2 - 10) / 2)
    least = 1e-9 * HBM_BYTES_PER_S  # one nanosecond's bytes a call, against 5 ns of kernels a call
    assert _read("attn_kernels_roofline", tr, {"attn_least_bytes": least}) == approx(20.0)
    assert _read("device_idle_share.attn", tr) == approx(99.0)
    bare = _trace([(0, 500, 1, CALL_SPAN), (500, 1000, 1, CALL_SPAN), (20, 60, 1, "aten::mm")])
    assert _read("attn_host_ms", bare) is None
    assert _read("attn_kernels_roofline", bare) is None


def test_a_traced_cpu_run_reads_the_attention_spans():
    """The tiny traffic traced on the CPU with the cell's metrics: the host
    spans are read; the device metrics find no device events."""
    cell = tiny_cell("gt-train")
    cell = harness.Cell(cell.name, 1, cell.config, cell.traffic, cell.end_to_end, harness.load_cell(CELL).per_layer)
    line = harness.run_cell(cell, 2**31 + 5, 0.3, True, "cpu")
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"attn_host_ms"} and line["metrics"]["attn_host_ms"]["value"] > 0


def test_the_undirected_stand_in_is_symmetric_with_one_degree_law():
    """``undirected_powerlaw``: each pair stored both ways, no self-loop, no
    repeat, columns ascending, within 0.5% of the entries asked for, the
    same graph from the same seed; its degree law puts some rows far above
    the median (the cell's leftover rows), and the cell's configuration
    makes its graph through it at the published counts."""
    from portbench.calls.graph_transformer import _graph
    from portbench.gen.undirected import undirected_powerlaw

    n, nnz = 20_000, 1_000_000
    indptr, indices = undirected_powerlaw(n, nnz, seed=2**31 + 7, max_degree=2000)
    assert indptr.dtype == indices.dtype == np.int32 and abs(len(indices) - nnz) <= nnz // 200
    rows = np.repeat(np.arange(n), np.diff(indptr))
    keys = rows.astype(np.int64) * n + indices
    assert np.all(np.diff(keys) > 0) and not np.any(rows == indices)
    assert np.array_equal(np.sort(indices.astype(np.int64) * n + rows), keys)  # (i, j) and (j, i) alike
    deg = np.diff(indptr)
    assert deg.max() > 20 * np.median(deg) and deg.max() <= 2300
    again = undirected_powerlaw(n, nnz, seed=2**31 + 7, max_degree=2000)
    assert np.array_equal(again[0], indptr) and np.array_equal(again[1], indices)
    cfg = harness.load_cell(CELL).config
    assert cfg["generator"]["name"] == "undirected_powerlaw"
    assert (cfg["generator"]["n"], cfg["generator"]["nnz"]) == (cfg["published"]["nodes"],
                                                                cfg["published"]["directed_entries"])
    small = dict(cfg, generator=dict(cfg["generator"], n=3000, nnz=30_000))
    g = _graph(small, 5, "ones")
    assert g.n == 3000 and abs(g.nnz - 30_000) <= 150 and g.data.dtype == np.float32 and np.all(g.data == 1)
