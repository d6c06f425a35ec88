"""The port's measurement utilities (``utils/timing.py``, ``utils/profiling.py``,
``ops/roofline.py``) on the CPU: the counterparts of ``spmm_tpu/utils`` and of
the datasheet half of ``spmm_tpu/ops/roofline.py``.  Times taken here are
host-clock times of CPU work and are only checked for shape and bookkeeping;
the roofline functions are pure arithmetic and must equal the JAX package's
given the same chip numbers.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from spmm_tpu.ops import roofline as jroof
from spmm_tpu.utils import timing as jtiming

from spmm_tpu_torch.ops import roofline as troof
from spmm_tpu_torch.utils import (
    OpTime, Profile, Timing, measure, measure_device_loop, measure_host, profile_fn,
)

from torch_parity import one_torch_thread  # noqa: F401  (autouse)


def test_measure_counts_and_fields():
    calls = []
    x = torch.ones(64, 64)

    def fn(a):
        calls.append(1)
        return a @ a

    t = measure(fn, x, name="mm", warmup=2, iters=4)
    assert isinstance(t, Timing) and t.name == "mm" and t.iters == 4
    assert len(calls) == 1 + 2 + 4  # first call apart, warm-up, timed runs
    assert t.clock == "host" and 0 < t.min_ms <= t.median_ms and t.min_ms <= t.mean_ms
    assert t.compile_ms > 0 and "mm:" in str(t) and "host clock" in str(t)
    # the JAX package's result type, field for field, plus the port's two
    jfields = [f for f in jtiming.Timing.__dataclass_fields__]
    assert [f for f in Timing.__dataclass_fields__][: len(jfields)] == jfields


def test_measure_asks_for_cuda_events_only_with_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        measure(lambda: torch.ones(2), cuda=True)  # no silent host-clock stand-in


def test_measure_device_loop_chains_the_carry():
    seen = []

    def step(c, a):
        seen.append(float(c[0]))
        return a * c

    t = measure_device_loop(step, torch.ones(3), (torch.tensor(2.0),), name="chain", iters=5, repeats=2)
    assert len(seen) == 1 + 5 * 2 and t.iters == 10 and t.clock == "host"
    assert seen[1:6] == [1.0, 2.0, 4.0, 8.0, 16.0] == seen[6:]  # each repeat restarts from init
    assert t.median_ms >= t.min_ms > 0


def test_measure_host():
    t = measure_host(sum, [1, 2, 3], name="sum", iters=5)
    assert t.iters == 5 and t.compile_ms == 0.0 and t.min_ms <= t.median_ms and t.clock == "host"
    tj = jtiming.measure_host(sum, [1, 2, 3], name="sum", iters=5)
    assert (t.name, t.iters, t.compile_ms) == (tj.name, tj.iters, tj.compile_ms)


def test_profile_fn_smoke():
    """``profile_fn`` runs and returns a Profile; device rows only appear on
    a card (as the JAX package's only appear on a TPU)."""
    calls = []

    def f(x):
        calls.append(1)
        return (x @ x.T).sum()

    p = profile_fn(f, torch.ones(64, 64), repeats=3)
    assert isinstance(p, Profile) and len(calls) == 1 + 3
    assert isinstance(p.top(3), str) and p.top(3).startswith("device total:")
    assert isinstance(p.by_source(), dict)
    if not torch.cuda.is_available():
        assert p.ops == [] and math.isnan(p.total_device_ms)
    fenced = []
    profile_fn(f, torch.ones(4, 4), fence=fenced.append, warm=False)
    assert len(fenced) == 1


def test_profile_aggregates_by_source():
    p = Profile(total_device_ms=3.5, ops=[OpTime("k1", 2.0, "aten::index_select", count=2),
                                          OpTime("k2", 1.0, "", count=1),
                                          OpTime("k3", 0.5, "aten::index_select", count=1)])
    assert p.by_source() == {"aten::index_select": 2.5, "?": 1.0}
    assert list(p.by_source()) == ["aten::index_select", "?"]
    assert "k1" in p.top(1) and "k2" not in p.top(1)


ROOFS = [
    ("spmm_roofline", (5_105_039, 916_428, 916_428, 128), {}),
    ("spmm_roofline", (1000, 50, 2000, 32), {"bytes_val": 2, "b_reuse": 3.5}),
    ("spmv_roofline", (5_105_039, 916_428, 916_428), {}),
    ("spgemm_roofline", (60_000_000, 5_105_039, 5_105_039, 25_000_000), {}),
    ("spgemm_roofline", (1000, 100, 100, 400), {"bytes_val": 8}),
]


@pytest.mark.parametrize("name,args,kw", ROOFS)
@pytest.mark.parametrize("chip", ["h100", "made_up"])
def test_roofline_equals_the_jax_package(name, args, kw, chip):
    nums = (dict(hbm_gbps=troof.H100_SXM.hbm_gbps, flops_f32=troof.H100_SXM.flops_f32,
                 flops_bf16=troof.H100_SXM.flops_bf16) if chip == "h100"
            else dict(hbm_gbps=123.0, flops_f32=4.5e12, flops_bf16=9e12))
    ct = troof.ChipSpec("x", **nums)
    cj = jroof.ChipSpec("x", vmem_bytes=0, **nums)
    rt = getattr(troof, name)(*args, chip=ct, **kw)
    rj = getattr(jroof, name)(*args, chip=cj, **kw)
    for f in ("flops", "hbm_bytes", "t_bandwidth_s", "t_compute_s", "t_sol_s"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert rt.efficiency(1e-3) == rj.efficiency(1e-3)
    assert rt.bound_by == ("bytes" if rj.t_bandwidth_s >= rj.t_compute_s else "operations")


def test_chip_spec_and_detect(monkeypatch):
    h = troof.H100_SXM
    assert (h.hbm_gbps, h.flops_f32, h.flops_f64, h.flops_f64_tensor, h.flops_bf16, h.flops_tf32,
            h.l2_bytes) == (3350.0, 67e12, 34e12, 67e12, 989e12, 495e12, 50_000_000)
    with pytest.raises(ValueError, match="ChipSpec"):  # no made-up rates for a CPU
        troof.detect_chip("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            troof.detect_chip()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            troof.spmm_roofline(10, 5, 5, 4)
    # an operation count at another type's peak
    r = troof.Roofline(flops=2e12, hbm_bytes=1e6, chip=h, peak_flops=h.flops_f64)
    assert r.bound_by == "operations" and r.t_sol_s == 2e12 / 34e12
    assert troof.Roofline(flops=1.0, hbm_bytes=3.35e9, chip=h).bound_by == "bytes"
    # the datasheet goes to the SXM card only: the PCIe and NVL cards have
    # other memory rates and power limits
    from spmm_tpu_torch.formats import containers

    monkeypatch.setattr(containers, "compute_device", lambda device="cuda": torch.device(device))
    for name, sxm in (("NVIDIA H100 80GB HBM3", True), ("NVIDIA H100 SXM5 64GB", True),
                      ("NVIDIA H100 PCIe", False), ("NVIDIA H100 NVL", False),
                      ("NVIDIA A100-SXM4-80GB", False)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None, name=name: name)
        if sxm:
            assert troof.detect_chip() is h, name
        else:
            with pytest.raises(ValueError, match="ChipSpec"):
                troof.detect_chip()
    # the measured rates have no default of any device: no module-level rates
    # and no defaults in the class
    assert not hasattr(troof, "V5E_RATES")
    assert all(f.default is dataclasses.MISSING for f in dataclasses.fields(troof.MeasuredRates)
               if not f.name.endswith("_curve"))
