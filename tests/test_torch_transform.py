"""The port's sparse transforms (``spmm_tpu_torch/ops/transform.py``) against
scipy and the JAX package's ``spmm_tpu/ops/transform.py``.

Mirrors ``tests/test_transform.py``.  Its four example workloads (pagerank,
bfs, cg_solver, triangle_count in ``examples/``) are JAX programs; here each is
written out with the port's transforms and ops at the same sizes and held
against the same oracle.  Transforms are host numpy, so the port's results
equal the JAX package's exactly.
"""

import numpy as np
import scipy.sparse as sp
import torch

from spmm_tpu.formats.containers import CSR as JCSR
from spmm_tpu.ops import transform as jt

from spmm_tpu_torch import ops
from spmm_tpu_torch.formats import CSR
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.ops.transform import (
    add,
    col_sums,
    diagonal,
    row_sums,
    scale_cols,
    scale_rows,
    transpose,
)

from torch_parity import assert_same, one_torch_thread  # noqa: F401  (autouse)


def _rand(m, n, d, seed):
    A = sp.random(m, n, density=d, random_state=seed, format="csr", dtype=np.float32)
    A.data[:] = np.random.default_rng(seed).standard_normal(len(A.data)).astype(np.float32)
    return A


def test_transpose():
    A = _rand(80, 50, 0.08, 0)
    T = transpose(CSR.from_scipy(A))
    ref = A.T.tocsr()
    ref.sort_indices()
    assert (T.to_scipy() != ref).nnz == 0
    assert_same(T, jt.transpose(JCSR.from_scipy(A)))


def test_transpose_roundtrip():
    A = _rand(33, 77, 0.1, 1)
    back = transpose(transpose(CSR.from_scipy(A))).to_scipy()
    assert (back != A).nnz == 0


def test_add():
    A = _rand(60, 60, 0.05, 2)
    B = _rand(60, 60, 0.05, 3)
    C = add(CSR.from_scipy(A), CSR.from_scipy(B), alpha=2.0, beta=-0.5)
    ref = (2.0 * A - 0.5 * B).tocsr()
    np.testing.assert_allclose(C.to_scipy().toarray(), ref.toarray(), rtol=1e-6, atol=1e-7)
    assert_same(C, jt.add(JCSR.from_scipy(A), JCSR.from_scipy(B), alpha=2.0, beta=-0.5))


def test_diagonal_and_sums():
    A = _rand(40, 40, 0.15, 4)
    Ac, Aj = CSR.from_scipy(A), JCSR.from_scipy(A)
    np.testing.assert_allclose(diagonal(Ac), A.diagonal(), rtol=1e-6)
    np.testing.assert_allclose(row_sums(Ac), np.asarray(A.sum(axis=1)).ravel(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(col_sums(Ac), np.asarray(A.sum(axis=0)).ravel(), rtol=1e-5, atol=1e-6)
    for f, fj in ((diagonal, jt.diagonal), (row_sums, jt.row_sums), (col_sums, jt.col_sums)):
        np.testing.assert_array_equal(f(Ac), fj(Aj))


def test_scaling():
    A = _rand(30, 45, 0.2, 5)
    Ac = CSR.from_scipy(A)
    s = np.random.default_rng(6).uniform(0.5, 2.0, 30).astype(np.float32)
    t = np.random.default_rng(7).uniform(0.5, 2.0, 45).astype(np.float32)
    np.testing.assert_allclose(scale_rows(Ac, s).to_scipy().toarray(), (sp.diags(s) @ A).toarray(), rtol=1e-6)
    np.testing.assert_allclose(scale_cols(Ac, t).to_scipy().toarray(), (A @ sp.diags(t)).toarray(), rtol=1e-6)
    assert_same(scale_rows(Ac, s), jt.scale_rows(JCSR.from_scipy(A), s))
    assert_same(scale_cols(Ac, t), jt.scale_cols(JCSR.from_scipy(A), t))


def _row_normalized(A):
    d = row_sums(A)
    return scale_rows(A, np.where(d > 0, 1.0 / np.maximum(d, 1e-30), 0.0)), d == 0


def test_random_walk_normalization_chain():
    """D⁻¹A chained SpMV (the reference's self-referential A x (A x ...)
    workload, SURVEY.md §2.8) with the port's transforms and ``spmv_xla``."""
    A = tsyn.webgraph_like(400, 2400, seed=8)
    P, _ = _row_normalized(A)
    x = np.random.default_rng(9).uniform(size=400).astype(np.float32)
    x /= x.sum()
    y = torch.from_numpy(x)
    Pd = P.pad(8).to("cpu")
    for _ in range(3):
        y = ops.spmv_xla(Pd, y)
    ref = x.copy()
    for _ in range(3):
        ref = P.to_scipy() @ ref
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-6)


def test_pagerank_matches_dense():
    """PageRank as examples/pagerank.py computes it (P = D⁻¹A, Pᵀ packed,
    dangling mass re-injected), through the port's transforms and SpMV,
    against the dense-numpy oracle."""
    n, damping = 300, 0.85
    A = tsyn.webgraph_like(n, 1800, seed=12)
    P, dangling = _row_normalized(A)
    Pt = transpose(P)
    x = torch.full((n,), 1.0 / n)
    dang = torch.from_numpy(dangling)
    for _ in range(80):
        x = damping * (ops.spmv(Pt, x) + x[dang].sum() / n) + (1.0 - damping) / n
    M = A.to_scipy().toarray().astype(np.float64)
    d = M.sum(1)
    Pm = np.where((d == 0)[:, None], 0.0, M / np.maximum(d, 1e-30)[:, None])
    ref = np.full(n, 1 / n)
    for _ in range(80):
        ref = damping * (Pm.T @ ref + ref[d == 0].sum() / n) + (1 - damping) / n
    np.testing.assert_allclose(x.numpy(), ref, rtol=5e-3, atol=1e-6)


def test_bfs_matches_scipy():
    """Level-synchronous BFS as examples/bfs.py computes it (frontier push
    through Aᵀ f > 0), through the port's transpose and SpMV, against
    scipy.sparse.csgraph."""
    from scipy.sparse.csgraph import shortest_path

    n = 400
    A = tsyn.webgraph_like(n, 2400, seed=13)
    At = transpose(A)
    At = CSR((np.asarray(At.data) != 0).astype(np.float32), At.indices, At.indptr, At.shape, At.nnz)
    dist = torch.full((n,), -1, dtype=torch.int32)
    dist[0] = 0
    frontier = torch.zeros(n)
    frontier[0] = 1.0
    level = 0
    while frontier.sum() > 0:
        fresh = (ops.spmv(At, frontier) > 0) & (dist < 0)
        dist[fresh] = level + 1
        frontier = fresh.float()
        level += 1
    ref = shortest_path(A.to_scipy(), method="D", unweighted=True, indices=0)
    ref_i = np.where(np.isinf(ref), -1, ref).astype(np.int32)
    np.testing.assert_array_equal(dist.numpy(), ref_i)
    assert level - 1 == int(ref_i.max())


def test_add_empty_operands():
    Z = CSR.from_scipy(sp.csr_matrix((7, 9), dtype=np.float32))
    C = add(Z, Z)
    assert C.nnz == 0 and C.shape == (7, 9)
    A = _rand(7, 9, 0.2, 11)
    np.testing.assert_allclose(add(CSR.from_scipy(A), Z).to_scipy().toarray(), A.toarray())


def test_cg_solver_converges():
    """CG on (L + eps I) as examples/cg_solver.py builds it (symmetric part,
    degree diagonal, via the port's add/transpose/row_sums), SpMV through the
    port."""
    A = tsyn.webgraph_like(400, 2400, seed=13)
    S = add(A, transpose(A), alpha=0.5, beta=0.5)
    D = CSR.from_scipy(sp.diags(row_sums(S) + 0.1).tocsr())
    L = add(D, S, alpha=1.0, beta=-1.0)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(400).astype(np.float32))
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = r @ r
    for _ in range(300):
        Ap = ops.spmv(L, p)
        alpha = rs / (p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        if rs_new.sqrt() < 1e-8 * b.norm():
            break
        p = r + (rs_new / rs) * p
        rs = rs_new
    res = np.linalg.norm(L.to_scipy() @ x.numpy() - b.numpy()) / np.linalg.norm(b.numpy())
    assert res < 1e-3, res


def test_triangle_count_matches_scipy():
    """Triangles = sum(A ∘ (A @ A)) / 6 as examples/triangle_count.py counts
    them, with A symmetrised by the port's transforms and A @ A through the
    port's slab SpGEMM (pattern mode)."""
    A = tsyn.webgraph_like(1200, 9000, seed=4)
    U = add(A, transpose(A))
    Us = U.to_scipy()
    Us.setdiag(0)
    Us.eliminate_zeros()
    Us.data[:] = 1.0
    U = CSR.from_scipy(Us.astype(np.float32))
    C = ops.spgemm(U, U, device="cpu")
    t = C.to_scipy().multiply(U.to_scipy()).sum() / 6.0
    S = U.to_scipy()
    ref = (S @ S).multiply(S).sum() / 6.0
    assert abs(t - ref) < 0.5, (t, ref)
    assert t > 0
