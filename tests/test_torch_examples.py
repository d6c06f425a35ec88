"""The four graph programs of the port (``examples/*_torch.py``) against the
JAX programs beside them (``examples/*.py``) on the same seeded graphs, with
``device="cpu"`` (the kernels' plain versions): PageRank ranks within 1e-5
and the same iteration count to within one, the same BFS distances and level count, the
same triangle count, and a CG residual history within 1e-3 relative while it
is above 1e-6 of its start (on a well-conditioned system: see that test).  Each is also held against scipy, and each
defaults to the card and raises without one, naming ``device="cpu"``.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spmm_tpu.formats import synthetic as jsyn

from spmm_tpu_torch.formats.convert import from_numpy

from torch_parity import assert_same, one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pagerank_matches_the_jax_program():
    A = jsyn.webgraph_like(2000, 12000, seed=12)
    rj, itj = _example("pagerank").pagerank(A, iters=40)
    stats = {}
    rt, itt = _example("pagerank_torch").pagerank(from_numpy(A), iters=40, device="cpu", stats=stats)
    # the stop test compares an fp32 sum of 2,000 differences with 1e-8: at
    # the crossing the two packages' sums may differ in the last bit
    assert abs(itt - itj) <= 1 and stats["loop_ms"] > 0
    np.testing.assert_allclose(rt, rj, rtol=1e-5, atol=1e-5)
    assert abs(rt.sum() - 1.0) < 1e-3
    # the dense power iteration
    M = A.to_scipy().toarray().astype(np.float64)
    d = M.sum(1)
    P = np.where((d == 0)[:, None], 0.0, M / np.maximum(d, 1e-30)[:, None])
    ref = np.full(2000, 1 / 2000)
    for _ in range(40):
        ref = 0.85 * (P.T @ ref + ref[d == 0].sum() / 2000) + 0.15 / 2000
    np.testing.assert_allclose(rt, ref, rtol=5e-3, atol=1e-6)


def test_cg_matches_the_jax_program():
    """The residual histories agree within 1e-3 while above 1e-6 of their
    start, on a unit-weight graph of even degree (eps = 0.1).  On a web
    graph's hub-heavy Laplacian fp32 CG amplifies a last-bit difference about
    fivefold per step, so any two fp32 implementations part after some eight
    steps: there the first six steps are compared, and both solutions are
    held to scipy's residual."""
    import dataclasses

    jm, tm = _example("cg_solver"), _example("cg_solver_torch")
    b = np.random.default_rng(1).standard_normal(2000).astype(np.float32)

    A0 = jsyn.random_csr(2000, 2000, 0.003, seed=13)
    A = dataclasses.replace(A0, data=(np.asarray(A0.data) != 0).astype(np.float32))
    Lj = jm.laplacian_system(A, 0.1)
    Lt = tm.laplacian_system(from_numpy(A), 0.1)
    assert_same(Lt, Lj)
    xj, hj = jm.cg(Lj, b, iters=120)
    stats = {}
    xt, ht = tm.cg(Lt, b, iters=120, device="cpu", stats=stats)
    n = min(len(hj), len(ht))
    live = hj[:n] > 1e-6 * hj[0]
    assert live.sum() > 20 and stats["loop_ms"] > 0
    np.testing.assert_allclose(ht[:n][live], hj[:n][live], rtol=1e-3)
    assert ht[-1] < 1e-5 * ht[0]  # the residual falls
    res = np.linalg.norm(Lt.to_scipy() @ xt - b) / np.linalg.norm(b)
    assert res < 1e-4, res

    W = jsyn.webgraph_like(2000, 12000, seed=13)
    Lj = jm.laplacian_system(W)
    Lt = tm.laplacian_system(from_numpy(W))
    assert_same(Lt, Lj)
    xj, hj = jm.cg(Lj, b, iters=120)
    xt, ht = tm.cg(Lt, b, iters=120, device="cpu")
    np.testing.assert_allclose(ht[:6], hj[:6], rtol=1e-3)
    res_t = np.linalg.norm(Lt.to_scipy() @ xt - b) / np.linalg.norm(b)
    res_j = np.linalg.norm(Lt.to_scipy() @ xj - b) / np.linalg.norm(b)
    assert res_t < 1.0 and res_t < 3 * res_j, (res_t, res_j)


@pytest.mark.parametrize("source", [0, 17])
def test_bfs_matches_the_jax_program(source):
    from scipy.sparse.csgraph import shortest_path

    A = jsyn.webgraph_like(3000, 15000, seed=14)
    dj, lj = _example("bfs").bfs(A, source)
    stats = {}
    dt, lt = _example("bfs_torch").bfs(from_numpy(A), source, device="cpu", stats=stats)
    assert dt.dtype == np.int32 and lt == lj and stats["levels"] == lt + 1
    np.testing.assert_array_equal(dt, np.asarray(dj))
    ref = shortest_path(A.to_scipy(), method="D", unweighted=True, indices=source)
    np.testing.assert_array_equal(dt, np.where(np.isinf(ref), -1, ref).astype(np.int32))


def test_bfs_max_levels():
    A = from_numpy(jsyn.webgraph_like(3000, 15000, seed=14))
    dist, levels = _example("bfs_torch").bfs(A, 0, max_levels=2, device="cpu")
    assert dist.max() == 2 and levels == 1


def test_triangle_count_matches_the_jax_program():
    A = jsyn.webgraph_like(1200, 9000, seed=4)
    jm, tm = _example("triangle_count"), _example("triangle_count_torch")
    Uj = jm.symmetrize(A)
    Ut = tm.symmetrize(from_numpy(A))
    assert_same(Ut, Uj)
    tj = jm.count_triangles(Uj)
    tt = tm.count_triangles(Ut, device="cpu")
    S = Ut.to_scipy()
    ref = (S @ S).multiply(S).sum() / 6.0
    assert tt == tj == ref and tt > 0


@pytest.mark.parametrize("name", ["pagerank", "cg_solver", "bfs", "triangle_count"])
def test_examples_default_to_the_card(name):
    """Without a CUDA device the default raises and names ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs")
    A = from_numpy(jsyn.webgraph_like(100, 500, seed=0))
    mod = _example(f"{name}_torch")
    run = {"pagerank": lambda: mod.pagerank(A),
           "cg_solver": lambda: mod.cg(mod.laplacian_system(A), np.ones(100, np.float32)),
           "bfs": lambda: mod.bfs(A, 0),
           "triangle_count": lambda: mod.count_triangles(mod.symmetrize(A))}[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run()


@pytest.mark.parametrize("name,extra", [
    ("pagerank", ["--iters", "10"]), ("cg_solver", ["--iters", "20"]), ("bfs", []),
    ("triangle_count", ["--check"]),
])
def test_example_programs_run_on_the_cpu(name, extra):
    """``python examples/<name>_torch.py --device cpu`` runs from any
    directory and prints its result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", f"{name}_torch.py"), "--n", "2000", "--nnz",
         "10000", "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=300, cwd=os.path.dirname(ROOT),
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    word = {"pagerank": "pagerank:", "cg_solver": "cg:", "bfs": "bfs:", "triangle_count": "match=True"}[name]
    assert word in out.stdout
