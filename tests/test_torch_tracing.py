"""The port's spans (``utils/profiling.py: span``) on the CPU: which ``spmm.*``
spans each route through ``ops.spgemm`` and the SpMM entry points records
under ``torch.profiler``, and the gate that makes a span free when no
profiler runs.  The autograd route of ``ell_spmm`` (``_EllSlabsSpmm``) runs
only on the card: ``tests/test_torch_cuda.py`` holds its span test.
"""

import threading

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from spmm_tpu_torch import ops
from spmm_tpu_torch.formats import ell_pack
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.ops import ell_kernel, slab_spgemm
from spmm_tpu_torch.utils import profiling
from spmm_tpu_torch.utils.profiling import span

from torch_parity import one_torch_thread, rhs  # noqa: F401  (autouse)

SPGEMM_LAYERS = ("pattern", "sizing", "plan_lookup", "tables", "numeric", "compact", "to_host")


def _profiled(fn):
    """``fn()`` under a CPU profiler: (its result, the profiler's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _spans(events) -> dict:
    """Each ``spmm.*`` span recorded: name -> the names of its enclosing events."""
    out = {}
    for e in events:
        if e.name.startswith(profiling.SPAN_PREFIX):
            up, p = [], e.cpu_parent
            while p is not None:
                up.append(p.name)
                p = p.cpu_parent
            out.setdefault(e.name, up)
    return out


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not autograd_profiler._is_profiler_enabled
    assert span("spmm.a") is span("spmm.b")
    with span("spmm.a") as inner:
        assert inner is None


def test_the_gate_is_read_at_entry_on_every_thread():
    """A profiler started after the program's modules were imported sees the
    spans: ``torch.profiler.profile.start()`` sets the flag the gate reads,
    and a thread that did not start the profiler reads it too (torch's
    per-thread C flag is unset there)."""
    off = span("spmm.x")
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled
        on = span("spmm.x")
        seen = []
        t = threading.Thread(target=lambda: seen.append(span("spmm.x")))
        t.start()
        t.join()
        with on:
            pass
    finally:
        prof.stop()
    assert isinstance(on, torch.profiler.record_function) and on is not off
    assert isinstance(seen[0], torch.profiler.record_function)
    assert span("spmm.x") is off
    assert "spmm.x" in _spans(prof.events())


def test_spgemm_spans_across_the_plan_cache(monkeypatch):
    """Three products of one operand object: the first names every layer
    of a product without a plan, the second builds the plan, the third hits
    it and builds no tables; every span lies inside ``spmm.spgemm``."""
    monkeypatch.setattr(slab_spgemm, "AUTO_PLAN_MIN_NNZ", 1)
    monkeypatch.setattr(slab_spgemm, "_PLAN_SEEN", {})
    monkeypatch.setattr(slab_spgemm, "_PLAN_CACHE", {})
    A = tsyn.webgraph_like(600, 3000, seed=3)
    calls = [_profiled(lambda: ops.spgemm(A, A, device="cpu")) for _ in range(3)]
    spans = [_spans(events) for _, events in calls]
    for s in spans:
        assert "spmm.spgemm" in s
        for name, up in s.items():
            assert name == "spmm.spgemm" or "spmm.spgemm" in up, name
    first = {f"spmm.spgemm.{n}" for n in SPGEMM_LAYERS}
    assert set(spans[0]) == first | {"spmm.spgemm"}
    assert set(spans[1]) == first | {"spmm.spgemm", "spmm.spgemm.plan_build"}
    assert "spmm.spgemm.plan_build" in spans[1]["spmm.spgemm.tables"]
    assert set(spans[2]) == (first - {"spmm.spgemm.tables"}) | {"spmm.spgemm", "spmm.spgemm.plan_hit"}
    C = [c for c, _ in calls]
    S = (A.to_scipy() @ A.to_scipy()).sorted_indices()
    for c in C:
        assert np.array_equal(c.indptr, S.indptr) and np.array_equal(c.indices[: c.nnz], S.indices)
        np.testing.assert_allclose(c.data[: c.nnz], S.data, rtol=1e-5, atol=1e-5)


def test_no_span_is_made_without_a_profiler(monkeypatch):
    """With no profiler running, a product and an SpMM through every route
    with spans make no ``record_function``: each span is the shared no-op."""

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(slab_spgemm, "AUTO_PLAN_MIN_NNZ", 1)
    monkeypatch.setattr(slab_spgemm, "_PLAN_SEEN", {})
    monkeypatch.setattr(slab_spgemm, "_PLAN_CACHE", {})
    A = tsyn.webgraph_like(300, 1500, seed=4)
    for _ in range(3):  # no plan, the plan's build, a hit
        ops.spgemm(A, A, device="cpu")
    E = ell_pack(A).to("cpu")
    B = torch.from_numpy(rhs(300, 4, 5))
    rows = sum(int(c.shape[0]) for c in E.cols)
    ops.ell_spmm(E, B)
    ell_kernel.ell_slabs_spmm_transposed(E.cols, E.data, B[:rows], 300)
    ell_kernel.ell_slabs_sddmm(E.cols, B[:rows], B)


def test_spmm_entry_spans():
    """``ell_spmm`` and the two backward routes, called on CPU tensors, each
    record their span."""
    A = tsyn.webgraph_like(400, 2400, seed=5)
    E = ell_pack(A).to("cpu")
    B = torch.from_numpy(rhs(400, 8, 6))
    dY = torch.from_numpy(rhs(400, 8, 7))
    rows = sum(int(c.shape[0]) for c in E.cols)
    _, events = _profiled(lambda: ops.ell_spmm(E, B))
    assert "spmm.ell_spmm" in _spans(events)
    _, events = _profiled(lambda: ell_kernel.ell_slabs_spmm_transposed(E.cols, E.data, dY[:rows], 400))
    assert "spmm.ell.transposed" in _spans(events)
    _, events = _profiled(lambda: ell_kernel.ell_slabs_sddmm(E.cols, dY[:rows], B))
    assert "spmm.ell.sddmm" in _spans(events)


@pytest.mark.parametrize("name", ["spmm.ell_spmm", "spmm.spgemm.sizing"])
def test_profile_fn_reports_the_spans(name):
    """``profile_fn``'s ``spans``: host ms per run of each ``spmm.*`` span,
    printed by ``top()`` after the kernels."""
    A = tsyn.webgraph_like(300, 1500, seed=8)
    if name == "spmm.ell_spmm":
        E = ell_pack(A).to("cpu")
        B = torch.from_numpy(rhs(300, 4, 9))
        p = profiling.profile_fn(lambda: ops.ell_spmm(E, B), repeats=2)
    else:
        p = profiling.profile_fn(lambda: ops.spgemm(A, A, device="cpu"), repeats=2)
    assert name in p.spans and p.spans[name] > 0
    assert all(k.startswith(profiling.SPAN_PREFIX) for k in p.spans)
    assert list(p.spans.values()) == sorted(p.spans.values(), reverse=True)
    assert name in p.top()
