"""Each cell rehearsed on the CPU at a tiny size through the whole run (the
kernels' plain versions): correct on the program, not correct with the
control in its place or with a fault planted in the timed path; no JAX
package loaded; no result without the program."""

import dataclasses
import importlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import CELLS, TRAFFIC, tiny_cell

SEED = 2**31 + 3  # seeds run past 32 signed bits


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    cell = harness.load_cell(name)
    assert cell.kind.KEEP >= 1 and cell.end_to_end and cell.per_layer
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(importlib.import_module(f"portbench.metrics.{harness.reader_of(m['name'])}").read)
    assert not cell.config["reduced"]


@pytest.mark.parametrize("traffic", TRAFFIC)
@pytest.mark.parametrize("trace", [0, 1])
def test_traffic_runs_correct_on_the_cpu(traffic, trace):
    cell = tiny_cell(traffic)
    line = harness.run_cell(cell, SEED, 0.3, bool(trace), "cpu")
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and list(line)[-1] == "checks"
    if trace:  # no device events on the CPU: every per-layer reader finds nothing
        assert line["metrics"] == {} and "breakdown" in line
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    json.dumps(harness.finite(line), allow_nan=False)


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_control_in_the_programs_place_is_not_correct(traffic):
    cell = tiny_cell(traffic)
    kind = cell.kind
    state = kind.setup(cell.config, cell.traffic, SEED, "cpu")
    out = kind.control(state, "cpu")
    kind.release(state)
    checks = kind.judge(state, [(0, out)], "cpu")
    assert checks and not all(c.ok for c in checks)


def _alter_value(C):
    data = C.data.copy()
    i = int(np.abs(data[: C.nnz]).argmax())
    data[i] *= 1.1
    return dataclasses.replace(C, data=data)


def _alter_index(C):
    indices = C.indices.copy()
    r = int(np.argmax(np.diff(C.indptr)))
    row = indices[C.indptr[r] : C.indptr[r + 1]]
    indices[C.indptr[r]] = np.setdiff1d(np.arange(C.shape[1]), row)[0]
    return dataclasses.replace(C, indices=indices)


def _half_rows(C):
    half = C.shape[0] // 2
    cut = int(C.indptr[half])
    indptr = np.asarray(C.indptr, np.int64).copy()
    indptr[half:] = cut
    return dataclasses.replace(C, data=C.data[:cut], indices=C.indices[:cut], indptr=indptr, nnz=cut)


def _spmm_identity(E, B, **kw):  # the step returns its state unchanged
    return B * 1.0


def _spmm_half(real):  # half of the rows left out, the rest scaled to keep the sum's size
    def f(E, B, **kw):
        y = real(E, B, **kw)
        keep = torch.arange(y.shape[0]) < y.shape[0] // 2
        return torch.where(keep[:, None], y * 2**0.5, 0.0)
    return f


def _spmm_altered(real):  # one answer altered where it is produced
    def f(E, B, **kw):
        y = real(E, B, **kw)
        i = int(y.detach().abs().argmax())
        bump = torch.zeros_like(y).view(-1)
        bump[i] = 1e-2 * y.detach().view(-1)[i]
        return y + bump.view(y.shape)
    return f


def _faults(kind_name, ops):
    if kind_name == "spgemm":
        real = ops.spgemm
        return {f.__name__: (lambda f: lambda A, B, **kw: f(real(A, B, **kw)))(f)
                for f in (_alter_value, _alter_index, _half_rows)}, "spgemm"
    real = ops.ell_spmm
    return {"state_unchanged": _spmm_identity, "half_batch": _spmm_half(real),
            "altered": _spmm_altered(real)}, "ell_spmm"


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_a_fault_in_the_timed_path_is_not_correct(traffic, monkeypatch):
    from spmm_tpu_torch import ops

    cell = tiny_cell(traffic)
    faults, attr = _faults(cell.traffic["call"], ops)
    assert len(faults) == 3
    for fault, fn in faults.items():
        with monkeypatch.context() as m:
            m.setattr(ops, attr, fn)
            line = harness.run_cell(cell, SEED, 0.2, False, "cpu")
        assert not line["correct"], (fault, line["checks"])


def _run_module(code: str, cwd: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_a_run_loads_no_jax_package():
    code = ("import torch; torch.set_num_threads(2)\n"
            "from portbench.tests.conftest import tiny_cell, TRAFFIC\n"
            "from portbench import harness\n"
            "for t in TRAFFIC: assert harness.run_cell(tiny_cell(t), 5, 0.1, False, 'cpu')['correct']\n"
            "import sys; print(sorted({m.split('.')[0] for m in sys.modules}))")
    res = _run_module(code, harness.ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    top = set(eval(res.stdout.strip().splitlines()[-1]))
    assert "spmm_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "spmm_tpu"}


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", TRAFFIC)
def test_traffic_runs_correct_on_the_card(traffic):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    line = harness.run_cell(tiny_cell(traffic), SEED, 0.5, True, "cuda")
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
