"""The traced window's arithmetic on a hand-made trace: the device's busy
union, the idle gaps named by the innermost host event, and the per-layer
readers."""

import importlib

import numpy as np
from pytest import approx

from portbench.counts.peaks import HBM_BYTES_PER_S
from portbench.trace import NO_HOST, Trace, breakdown


def _trace():
    a = lambda *v: np.array(v, np.int64)
    return Trace(
        t0=0, t1=40, calls=2,
        dev_start=a(0, 5, 20), dev_end=a(10, 15, 30),
        dev_kind=["kernel", "gpu_memcpy", "kernel"],
        dev_name=["k1", "Memcpy DtoH (Device -> Pageable)", "k2"],
        host_start=a(0, 12, 31, 16), host_end=a(40, 18, 39, 19),
        host_thread=a(1, 1, 1, 2), host_name=["outer", "a", "b", "other-thread"],
    )


def test_busy_union_and_idle_gaps():
    tr = _trace()
    assert tr.busy_s() == approx(25e-9)
    g0, g1 = tr.idle_gaps()
    assert g0.tolist() == [15, 30] and g1.tolist() == [20, 40]


def test_gaps_are_named_by_the_innermost_host_event():
    tr = _trace()
    assert tr.host_at(np.array([17, 35, 13, 1])) == ["other-thread", "b", "a", "outer"]
    empty = Trace(0, 10, 1, *[np.zeros(0, np.int64)] * 2, [], [], *[np.zeros(0, np.int64)] * 3, [])
    assert empty.host_at(np.array([5])) == [NO_HOST]
    b = breakdown(tr)
    assert dict(b["device_ops"]) == approx({"k1": 10e-9, "Memcpy DtoH (Device -> Pageable)": 10e-9, "k2": 10e-9})
    assert dict(b["idle_gaps"]) == approx({"other-thread": 5e-9, "b": 10e-9})


def test_readers():
    tr = _trace()
    read = lambda name, counts={}: importlib.import_module(f"portbench.metrics.{name}").read(tr, counts)
    assert read("device_idle_share") == approx(100 * (1 - 25 / 40))
    assert read("spgemm_d2h_ms") == approx(1e3 * 10e-9 / 2)
    least = 1e-9 * HBM_BYTES_PER_S  # one nanosecond's bytes a call, against 10 ns of kernels a call
    assert abs(read("spgemm_kernels_roofline", {"spgemm_least_bytes": least}) - 10.0) < 1e-9
    assert abs(read("spmm_kernels_roofline", {"spmm_least_bytes": least}) - 10.0) < 1e-9
    assert read("spmm_kernels_roofline") is None  # nothing to read: no value, not 0

