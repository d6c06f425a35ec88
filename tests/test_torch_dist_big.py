"""BASELINE config 5's script, ``python -m spmm_tpu_torch.utils.dist_big``
(the port of ``benchmarks/dist_big_cpu.py``), on the CPU at a small size:
``webgraph_like(20_000, 120_000, seed=5)`` on spawned gloo ranks, against
scipy (``indptr`` / ``indices`` / nnz exact; values within 1e-4 of max) and
the JAX package's ``spgemm_dist_big`` on the 8-device CPU mesh of
tests/conftest.py (its nnz)."""

import argparse
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_big as jax_dist_big
from spmm_tpu_torch.formats.synthetic import webgraph_like
from spmm_tpu_torch.utils import dist_big

N, NNZ, SEED = 20_000, 120_000, 5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX script's keys, then the port's
KEYS = ("n", "nnz_in", "nnz_out", "n_shards", "pieces", "dist_big_s", "mnnz_out_per_s", "scipy_s", "parity",
        "gen_s", "pieces_chosen", "sizing_s", "stitch_s", "piece_stats", "pieces_computed", "pieces_resumed",
        "host_rss_gb", "host_rss_product_gb", "launches", "device")


@pytest.fixture(scope="module")
def ref_nnz():
    """(scipy's nnz of A×A, the JAX package's ``spgemm_dist_big`` nnz on
    the 8-device CPU mesh with the JAX script's 4 pieces)."""
    A = webgraph_like(N, NNZ, seed=SEED)
    As = A.to_scipy()
    mesh = Mesh(np.array(jax.devices()).reshape(-1), ("rows",))
    Cj = jax_dist_big(jsyn.webgraph_like(N, NNZ, seed=SEED), jsyn.webgraph_like(N, NNZ, seed=SEED), mesh,
                      pieces=4)
    return int((As @ As).nnz), int(Cj.nnz)


def _cli(args, timeout=240):
    proc = subprocess.run([sys.executable, "-m", "spmm_tpu_torch.utils.dist_big", "--n", str(N), "--nnz",
                           str(NNZ), *args], cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    return proc, (json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None)


@pytest.mark.parametrize("pieces", [4, None], ids=["pieces4", "auto"])
@pytest.mark.parametrize("ranks", [1, 2])
def test_dist_big_exact_against_scipy_and_jax(ranks, pieces, ref_nnz):
    res = dist_big.run(N, NNZ, pieces=pieces, ranks=ranks, device="cpu")
    assert list(res)[: len(dist_big.JAX_KEYS)] == list(dist_big.JAX_KEYS)
    assert set(KEYS) <= set(res)
    assert res["parity"] == "exact"
    assert res["nnz_out"] == res["scipy_nnz"] == ref_nnz[0] == ref_nnz[1]
    assert res["n"] == N and res["n_shards"] == ranks and res["device"] == "cpu"
    assert res["pieces"] == ("auto" if pieces is None else pieces)
    P = res["pieces_chosen"]
    assert P == (4 if pieces else 1)  # 20K rows fit one piece's slab budget
    assert res["pieces_computed"] == P == len(res["piece_stats"]) and res["pieces_resumed"] == 0
    for p in res["piece_stats"]:
        assert p["device_ms"] is None  # no device number from a CPU run
        assert p["piece_ms"] > 0 and p["d2h_ms"] > 0 and p["sizing_ms"] > 0 and p["nnz"] > 0
    assert res["launches"] == {"slab_fetch_merge": 0, "slab_compact": 0}  # CPU tensors take the plain versions
    assert "peak_device_gb" not in res and "power_limit" not in res


def test_dist_big_values_and_single(ref_nnz):
    res = dist_big.run(N, NNZ, pieces=4, ranks=2, device="cpu", values=True, single=True)
    assert res["parity"] == "exact" and res["nnz_out"] == res["single_nnz_out"] == ref_nnz[0]
    assert 0 < res["max_abs_err"] <= dist_big.VALUE_RTOL * res["max_abs_ref"]
    assert res["slab_big_s"] > 0 and res["single_launches"] == {"slab_fetch_merge": 0, "slab_compact": 0}


def test_dist_big_skip_scipy():
    proc, res = _cli(["--device", "cpu", "--ranks", "2", "--skip-scipy"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert res["nnz_out"] > 0 and "parity" not in res and "scipy_s" not in res
    assert proc.stdout.splitlines()[0].startswith("generated: n=20000")


def test_dist_big_checkpoint_resumes_and_a_planted_mismatch_fails(tmp_path):
    """A checkpointed run, a resume that recomputes no piece (exact), then a
    piece file with one column changed: the resumed C differs from scipy's,
    the line says so and the exit code is 1."""
    ck = str(tmp_path / "ck")
    first = dist_big.run(N, NNZ, pieces=2, ranks=2, device="cpu", checkpoint_dir=ck)
    again = dist_big.run(N, NNZ, pieces=2, ranks=2, device="cpu", checkpoint_dir=ck)
    assert first["parity"] == again["parity"] == "exact"
    assert (first["pieces_computed"], first["pieces_resumed"]) == (2, 0)
    assert (again["pieces_computed"], again["pieces_resumed"]) == (0, 2)
    assert again["nnz_out"] == first["nnz_out"]
    fp = os.path.join(ck, "piece_00001.npz")
    with np.load(fp) as z:
        arrs = dict(z)
    arrs["ind1"][0] = (arrs["ind1"][0] + 1) % N  # rank 1's first entry of its second piece
    np.savez(fp, **arrs)
    proc, res = _cli(["--device", "cpu", "--ranks", "2", "--pieces", "2", "--checkpoint-dir", ck])
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert res["parity"] == "mismatch" and res["pieces_computed"] == 0
    assert "dist_big" in res["mismatch"]


def test_dist_big_without_a_card_fails_at_once_naming_cpu():
    proc, res = _cli([], timeout=60)
    assert proc.returncode != 0 and res is None
    assert "--device cpu" in proc.stderr
    with pytest.raises(RuntimeError, match="--device cpu"):
        dist_big.run(N, NNZ)


def test_pieces_argument():
    assert dist_big._pieces_arg("auto") is None and dist_big._pieces_arg("4") == 4
    with pytest.raises(argparse.ArgumentTypeError):
        dist_big._pieces_arg("0")
