"""The port's CLI end to end on the CPU: ingest → preprocess → ELL SpMM →
exact A×A SpGEMM, checked against scipy and the JAX package's preprocess."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spmm_tpu.config import Config as JConfig
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.preprocess import preprocess as jpreprocess

from spmm_tpu_torch import cli, ops
from spmm_tpu_torch.formats import to_coo, write_mtx
from spmm_tpu_torch.formats import synthetic as tsyn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _layout(tmp_path, names=("g1", "g2")):
    for i, name in enumerate(names):
        d = tmp_path / "mat" / "mtx" / name
        d.mkdir(parents=True)
        write_mtx(d / f"{name}.mtx", to_coo(tsyn.webgraph_like(900 + 300 * i, 6000, seed=i)),
                  pattern=True)
    (tmp_path / "matrix.txt").write_text("".join(f"{n}.mtx\n" for n in names))


def test_cli_reference_layout_cpu(tmp_path):
    _layout(tmp_path)
    rows = []
    rc = cli.main(["--dir", str(tmp_path), "--spgemm", "--spmm", "32", "--check", "--device", "cpu"],
                  results=rows)
    assert rc == 0
    lines = (tmp_path / "result.txt").read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == ["g1", "g2"]
    assert all(ln.split()[1].endswith("ms") for ln in lines)
    for i, r in enumerate(rows):
        assert r["check_ok"] and r["spgemm_exact"] and r["spgemm_max_err"] == 0.0
        assert r["spgemm_out_nnz"] == r["spgemm_ref_nnz"]
        assert r["spmm_max_err"] < 1e-4
        P = jpreprocess(jsyn.webgraph_like(900 + 300 * i, 6000, seed=i), JConfig())
        assert (r["regions"], r["v8_groups"]) == (P.nregions, P.ngroups)


def test_cli_single_matrix_values(tmp_path, capsys):
    p = tmp_path / "m.mtx"
    write_mtx(p, to_coo(tsyn.random_csr(400, 400, 0.01, seed=3)))
    rc = cli.main(["--matrix", str(p), "--values", "--spmm", "8", "--spgemm", "--check",
                   "--device", "cpu", "--region-budget", "64", "--section-size", "128"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "----name:m.mtx----" in out and "spgemm_exact: True" in out
    assert not (tmp_path / "result.txt").exists()


def test_cli_failed_check_returns_1(tmp_path, monkeypatch):
    _layout(tmp_path, ("g",))
    real = ops.spgemm

    def wrong(A, B, **kw):
        C = real(A, B, **kw)
        return type(C)(C.data, C.indices[::-1].copy(), C.indptr, C.shape, C.nnz)

    monkeypatch.setattr(ops, "spgemm", wrong)
    assert cli.main(["--dir", str(tmp_path), "--spgemm", "--check", "--device", "cpu"]) == 1


def test_cli_missing_matrix_list(tmp_path):
    assert cli.main(["--dir", str(tmp_path), "--device", "cpu"]) == 2


def test_cli_device_cuda_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid")
    _layout(tmp_path, ("g",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--dir", str(tmp_path), "--spgemm"])  # cuda is the default


def test_cli_module_entry_point(tmp_path):
    _layout(tmp_path, ("g",))
    res = subprocess.run(
        [sys.executable, "-m", "spmm_tpu_torch.cli", "--dir", str(tmp_path), "--spgemm",
         "--check", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert res.returncode == 0, res.stderr
    assert "spgemm_exact: True" in res.stdout
    name, ms = (tmp_path / "result.txt").read_text().split()
    assert name == "g" and float(ms[:-2]) >= 0
    assert np.isfinite(float(ms[:-2]))
