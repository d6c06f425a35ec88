"""The measured-rates half of ``ops/roofline.py`` and its probe
(``utils/primitives.py``) on the CPU.

``MeasuredRates`` and the four ``*_attainable`` bounds are pure arithmetic:
built from one synthetic rates dict (round numbers, no device's, curves out
of order), the port's and the JAX package's must agree within 1e-15
relative.  ``load`` reads only the H100 file and raises where the JAX
package falls back to its defaults.  The probe runs every primitive here at
a tiny size; its rates are checked for shape only (host-clock times of CPU
work), and it refuses to write them.
"""

import dataclasses
import json
import math

import pytest
import torch

from spmm_tpu.ops import roofline as jroof

from spmm_tpu_torch.ops import roofline as troof
from spmm_tpu_torch.utils import primitives

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

#: round numbers of no device; curves unsorted, of 3-5 points
RATES = {
    "row_gather_rows_s": 2e9,
    "scatter_elems_s": 3e10,
    "scalar_gather_s": 5e10,
    "sort_batched_s": 2e10,
    "sort_batched_curve": [[128, 1e10], [16, 2e10], [512, 4e9], [64, 1.5e10]],
    "sort_global_s": 1e9,
    "elementwise_gbs": 2e12,
    "row_gather_curve": [[1 << 30, 2e9], [1 << 24, 6e9], [1 << 26, 3e9]],
    "row_gather_narrow_curve": [[1 << 28, 2e10], [1 << 24, 8e10], [1 << 29, 1.5e10], [1 << 25, 6e10],
                                [1 << 26, 3e10]],
    "dispatch_fence_s": 2e-5,
}
NO_CURVES = {k: ([] if isinstance(v, list) else v) for k, v in RATES.items()}
H100_NAME = "NVIDIA H100 80GB HBM3"


def _kw(d):
    return {k: tuple(tuple(p) for p in v) if isinstance(v, list) else v for k, v in d.items()}


def _pair(d):
    return troof.MeasuredRates(**_kw(d)), jroof.MeasuredRates(**_kw(d))


def _same(t, j):
    assert math.isclose(t, j, rel_tol=1e-15, abs_tol=0.0), (t, j)


@pytest.mark.parametrize("rates", [RATES, NO_CURVES], ids=["curves", "no_curves"])
@pytest.mark.parametrize("width", [None, 0, 4, 16, 40, 64, 100, 128, 300, 512, 4096])
def test_sort_rate_equals_the_jax_package(rates, width):
    t, j = _pair(rates)
    _same(t.sort_rate(width), j.sort_rate(width))


TABLES = [None, 0, 1 << 20, 1 << 24, 3 << 23, 1 << 25, 5 << 24, 1 << 26, 1 << 28, 1 << 29, 1 << 30, 1 << 34]


@pytest.mark.parametrize("rates", [RATES, NO_CURVES, dict(RATES, row_gather_narrow_curve=[])],
                         ids=["curves", "no_curves", "no_narrow"])
@pytest.mark.parametrize("row_bytes", [None, 32, 64, 65, 512])
def test_row_gather_rate_equals_the_jax_package(rates, row_bytes):
    t, j = _pair(rates)
    for tb in TABLES:
        _same(t.row_gather_rate(tb, row_bytes), j.row_gather_rate(tb, row_bytes))
        if row_bytes is None:
            _same(t.row_gather_rate(tb), j.row_gather_rate(tb))


CHUNKS = ((16, 4_000_000), (24, 3_000_000), (64, 9_000_000), (200, 1_000_000), (1024, 700_000))
BOUNDS = [
    ("spmm_attainable", (5_181_495, 916_428, 128), {"table_bytes": 916_428 * 512}),
    ("spmm_attainable", (1000, 50, 32), {}),
    ("spmm_attainable", (123_457, 999, 1), {"table_bytes": 40e6}),
    ("spmv_attainable", (5_181_495,), {}),
    ("spmv_attainable", (7,), {}),
    ("spgemm_attainable", (6_249_020, 49_992_160, 5_124_438), {}),
    ("spgemm_attainable", (6_249_020, 49_992_160, 5_124_438, None),
     {"nrow_b": 916_428, "b2_table_bytes": 1_160_192 * 32, "b2_row_bytes": 32,
      "geom_table_bytes": 916_428 * 8, "out_nnz": 25_169_125, "chunk_slots": CHUNKS}),
    ("spgemm_attainable", (1000, 8000, 700, 650),
     {"nrow_b": 0, "b2_table_bytes": 5e8, "geom_table_bytes": 2e8, "geom_row_bytes": 65,
      "out_nnz": 0, "dispatches": 0.125}),
    ("spgemm_attainable", (1000, 8000, 700), {"out_nnz": None, "dispatches": 3, "chunk_slots": ()}),
    ("spgemm_warm_attainable", (49_992_160, 25_169_125), {}),
    ("spgemm_warm_attainable", (49_992_160, 25_169_125), {"dispatches": 1 / 8, "chunk_slots": CHUNKS}),
    ("spgemm_warm_attainable", (8000, 0), {"dispatches": 0.5}),
]


@pytest.mark.parametrize("rates", [RATES, NO_CURVES], ids=["curves", "no_curves"])
@pytest.mark.parametrize("name,args,kw", BOUNDS)
def test_attainable_bounds_equal_the_jax_package(rates, name, args, kw):
    t, j = _pair(rates)
    got = getattr(troof, name)(*args, rates=t, **kw)
    want = getattr(jroof, name)(*args, rates=j, **kw)
    assert got > 0
    _same(got, want)


def _write(path, d):
    path.write_text(json.dumps(d))
    return str(path)


def test_load_round_trip_and_refusals(tmp_path):
    good = dict(RATES, _device=H100_NAME, _power_limit="NVIDIA H100 80GB HBM3, 700.00 W")
    r = troof.MeasuredRates.load(_write(tmp_path / "r.json", good))
    assert r == troof.MeasuredRates(**_kw(RATES))
    assert r.row_gather_curve == tuple((float(a), float(b)) for a, b in RATES["row_gather_curve"])
    # no file: the message names the command that writes it
    with pytest.raises(FileNotFoundError, match="utils.primitives --json"):
        troof.MeasuredRates.load(str(tmp_path / "missing.json"))
    # no defaults of any device
    with pytest.raises(TypeError):
        troof.MeasuredRates()
    bad = {
        "no_field": {k: v for k, v in good.items() if k != "scatter_elems_s"},
        "no_curve": {k: v for k, v in good.items() if k != "row_gather_curve"},
        "tpu": dict(good, _device="TPU v5 lite"),
        "cpu": dict(good, _device="cpu"),
        "no_device": {k: v for k, v in good.items() if k != "_device"},
        "zero_rate": dict(good, sort_global_s=0.0),
        "nan_rate": dict(good, elementwise_gbs=float("nan")),
        "text_rate": dict(good, scalar_gather_s="5e10"),
        "bad_curve": dict(good, sort_batched_curve=[[16, 2e10, 3]]),
        "list": [good],
    }
    for name, d in bad.items():
        with pytest.raises(ValueError):
            troof.MeasuredRates.load(_write(tmp_path / f"{name}.json", d))
    (tmp_path / "torn.json").write_text('{"row_gather_rows_s": 2e9, ')
    with pytest.raises(ValueError, match="not a rates file"):
        troof.MeasuredRates.load(str(tmp_path / "torn.json"))
    # the JAX package's TPU file is refused too
    with pytest.raises(ValueError, match="not the name of a CUDA card"):
        troof.MeasuredRates.load(jroof.MeasuredRates.calibration_path())


def test_committed_file_names_an_h100():
    path = troof.MeasuredRates.calibration_path()
    assert path.endswith("spmm_tpu_torch/primitive_rates_h100.json")
    rates = troof.MeasuredRates.load()
    with open(path) as f:
        raw = json.load(f)
    assert "H100" in raw["_device"] and raw["_power_limit"].startswith(raw["_device"])
    assert raw["_power_limit"].endswith(" W") and raw["_cuda"]
    assert all(len(getattr(rates, c)) >= 4 for c in ("sort_batched_curve", "row_gather_curve",
                                                   "row_gather_narrow_curve"))
    # a bound asked for without rates reads this file
    assert troof.spmv_attainable(1000) == troof.spmv_attainable(1000, rates)
    assert troof.spgemm_warm_attainable(8000, 100, chunk_slots=CHUNKS) == troof.spgemm_warm_attainable(
        8000, 100, rates, chunk_slots=CHUNKS)


def test_probe_on_the_cpu_returns_every_field():
    lines = []
    r = primitives.measure_rates(size_log2=12, device="cpu", gather_tables_log2=(10, 12),
                                 narrow_tables_log2=(10, 12), log=lines.append)
    fields = {f.name for f in dataclasses.fields(troof.MeasuredRates)}
    assert set(r) == fields
    for k, v in r.items():
        vals = [x for pt in v for x in pt] if isinstance(v, tuple) else [v]
        assert vals and all(math.isfinite(x) and x > 0 for x in vals), k
    assert [L for L, _ in r["sort_batched_curve"]] == list(primitives.SORT_WIDTHS)
    assert [b for b, _ in r["row_gather_curve"]] == [(1 << 10) * 512, (1 << 12) * 512]
    assert [b for b, _ in r["row_gather_narrow_curve"]] == [(1 << 10) * 32, (1 << 12) * 32]
    assert r["elementwise_gbs"] > r["scalar_gather_s"]  # 8 bytes per cumsum element
    assert len(lines) == 37  # a line per measurement (three per gather)
    troof.MeasuredRates(**r)


def test_probe_refuses_to_write_off_the_card(tmp_path, monkeypatch):
    out = tmp_path / "rates.json"
    monkeypatch.setattr(troof.MeasuredRates, "calibration_path", staticmethod(lambda: str(out)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the probe measures the card, and there is none: it raises before it
    # measures anything, so `python -m ... --json` exits nonzero
    with pytest.raises(RuntimeError, match='device="cpu"'):
        primitives.main(["--json", "--size", "12"])
    assert not out.exists()
