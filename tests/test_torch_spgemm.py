"""Exact SpGEMM of the port against the JAX package's global-sort ESC and scipy.

``indptr``/``indices`` must be equal (exact structure); data within rtol 1e-5
(fp32 sums of the same partial products in another order; pattern matrices
give integer counts, which are exact).
"""

import numpy as np
import pytest
import scipy.sparse as sp

from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.ops import spgemm_coo_padded as j_coo_padded
from spmm_tpu.ops import spgemm_expand_bound as j_expand_bound
from spmm_tpu.ops import spgemm_sorted as j_spgemm

from spmm_tpu_torch import ops
from spmm_tpu_torch.formats import COO, CSR, to_csr
from spmm_tpu_torch.formats import synthetic as tsyn


def _scipy_product(A, B):
    ref = (A.to_scipy() @ B.to_scipy()).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    return ref


def _assert_exact(C, ref, Cj=None):
    np.testing.assert_array_equal(C.indptr, ref.indptr)
    np.testing.assert_array_equal(C.indices[: C.nnz], ref.indices)
    np.testing.assert_allclose(C.data[: C.nnz], ref.data, rtol=1e-5, atol=1e-6)
    if Cj is not None:
        np.testing.assert_array_equal(C.indptr, Cj.indptr)
        np.testing.assert_array_equal(C.indices[: C.nnz], np.asarray(Cj.indices[: Cj.nnz]))
        np.testing.assert_allclose(C.data[: C.nnz], np.asarray(Cj.data[: Cj.nnz]), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spgemm_axa_pattern_matches_jax_and_scipy(seed):
    Aj = jsyn.webgraph_like(1200, 8000, seed=seed)
    A = tsyn.webgraph_like(1200, 8000, seed=seed)
    C = ops.spgemm(A, A, device="cpu")
    _assert_exact(C, _scipy_product(A, A), j_spgemm(Aj, Aj))
    assert np.all(C.data[: C.nnz] == np.round(C.data[: C.nnz]))  # counts


@pytest.mark.parametrize("shape", [(300, 200, 250), (150, 400, 90)])
def test_spgemm_rectangular_real_values(shape):
    m, k, n = shape
    Aj, Bj = jsyn.random_csr(m, k, 0.03, seed=3), jsyn.random_csr(k, n, 0.03, seed=4)
    A, B = tsyn.random_csr(m, k, 0.03, seed=3), tsyn.random_csr(k, n, 0.03, seed=4)
    C = ops.spgemm(A, B, device="cpu")
    assert C.shape == (m, n)
    _assert_exact(C, _scipy_product(A, B), j_spgemm(Aj, Bj))


@pytest.mark.parametrize("budget", [1, 512, 5000])
def test_spgemm_chunked_matches_unchunked(budget):
    A = tsyn.webgraph_like(800, 5000, seed=5)
    whole = ops.spgemm(A, A, device="cpu")
    parts = ops.spgemm(A.to("cpu"), A, device="cpu", max_expand_per_chunk=budget)
    np.testing.assert_array_equal(whole.indptr, parts.indptr)
    np.testing.assert_array_equal(whole.indices, parts.indices)
    np.testing.assert_allclose(whole.data, parts.data, rtol=1e-6)
    _assert_exact(parts, _scipy_product(A, A))


def test_spgemm_expand_bound_and_coo_padded_match_jax():
    Aj = jsyn.webgraph_like(500, 3000, seed=6)
    A = tsyn.webgraph_like(500, 3000, seed=6)
    bound = ops.spgemm_expand_bound(A, A)
    assert bound == j_expand_bound(Aj, Aj)
    S = A.to_scipy()
    assert bound == int(np.diff(S.indptr)[S.indices].sum())
    size = bound + 37  # padding past the bound stays zero
    r, c, v, k = ops.spgemm_coo_padded(A.pad(8), A.pad(8), size, device="cpu")
    rj, cj, vj, kj = j_coo_padded(Aj.pad(8).device(), Aj.pad(8).device(), size)
    k = int(k)
    assert k == int(kj) == _scipy_product(A, A).nnz
    np.testing.assert_array_equal(r.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-6)
    assert not r[k:].any() and not c[k:].any() and not v[k:].any()


def test_spgemm_empty_operands_and_coo_output():
    Z = to_csr(COO(np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32),
                   (5, 5), 0))
    A = tsyn.random_csr(5, 5, 0.3, seed=1)
    for X, Y in ((Z, Z), (Z, A), (A, Z)):
        C = ops.spgemm(X, Y, device="cpu")
        assert C.nnz == 0 and C.shape == (5, 5)
        np.testing.assert_array_equal(C.indptr, np.zeros(6))
    # rows of A that only hit empty rows of B expand to nothing
    B = tsyn.random_csr(5, 5, 0.3, seed=2)
    B = sp.csr_matrix(B.to_scipy().multiply(np.arange(5)[:, None] % 2))
    B.eliminate_zeros()
    Bc = CSR.from_scipy(B)
    C = ops.spgemm(A, Bc, device="cpu", as_csr=False)
    assert isinstance(C, COO)
    ref = (A.to_scipy() @ B).tocoo()
    assert C.nnz == (A.to_scipy() @ B).tocsr().nnz
    np.testing.assert_allclose(sp.coo_matrix((C.data, (C.row, C.col)), shape=C.shape).toarray(),
                               ref.toarray(), rtol=1e-5, atol=1e-6)
