"""The plain references against scipy at small sizes, and their bfloat16
form (the control) measurably off."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench.reference.spgemm import spgemm
from portbench.reference.spmm import train_step


def _random_csr(m, n, density, seed, values=True):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, format="csr", random_state=rng, dtype=np.float64)
    if not values:
        A.data[:] = 1.0
    A.sort_indices()
    return A


def _t(A):
    return (torch.from_numpy(A.indptr.astype(np.int32)), torch.from_numpy(A.indices.astype(np.int32)),
            torch.from_numpy(A.data.astype(np.float32)))


@pytest.mark.parametrize("block", [1 << 24, 64])
def test_spgemm_matches_scipy_in_blocks(block):
    A = _random_csr(300, 200, 0.03, 1)
    B = _random_csr(200, 250, 0.04, 2)
    indptr, indices, data, scale = spgemm(*_t(A), *_t(B), 250, block=block)
    A32, B32 = A.astype(np.float32).astype(np.float64), B.astype(np.float32).astype(np.float64)
    C = (A32 @ B32).tocsr()
    C.sort_indices()
    assert np.array_equal(indptr.numpy(), C.indptr) and np.array_equal(indices.numpy(), C.indices)
    np.testing.assert_allclose(data.numpy(), C.data, rtol=1e-12, atol=1e-14)
    S = (abs(A32) @ abs(B32)).tocsr()
    S.sort_indices()
    np.testing.assert_allclose(scale.numpy(), S.data, rtol=1e-12)


def test_spgemm_keeps_cancelled_and_explicit_zero_entries():
    # row 0 reaches column 0 through two products that cancel; an explicit 0 in B
    A = sp.csr_matrix(np.array([[1.0, 1.0], [0.0, 1.0]]))
    B = sp.csr_matrix((np.array([2.0, -2.0, 0.0]), np.array([0, 0, 1]), np.array([0, 1, 3])), shape=(2, 2))
    indptr, indices, data, _ = spgemm(*_t(A), *_t(B), 2)
    assert indptr.tolist() == [0, 2, 4] and indices.tolist() == [0, 1, 0, 1]
    assert data.tolist() == [0.0, 0.0, -2.0, 0.0]


def test_spgemm_in_bfloat16_is_off():
    A = _random_csr(200, 200, 0.05, 3)
    _, _, ref, _ = spgemm(*_t(A), *_t(A), 200)
    _, _, low, _ = spgemm(*_t(A), *_t(A), 200, dtype=torch.bfloat16)
    assert low.dtype == torch.bfloat16
    assert 1e-4 < float((low.double() - ref).abs().max() / ref.abs().max()) < 0.05


@pytest.mark.parametrize("block", [1 << 18, 7])
def test_train_step_matches_dense_autograd(block):
    A = _random_csr(120, 120, 0.05, 4)
    X = torch.from_numpy(np.random.default_rng(5).standard_normal((120, 16)).astype(np.float32))
    r = train_step(*_t(A), X, block=block)
    Ad = torch.tensor(A.astype(np.float32).toarray(), dtype=torch.float64, requires_grad=True)
    Xd = X.double().requires_grad_()
    Y = Ad @ Xd
    loss = (Y * Y).sum()
    loss.backward()
    torch.testing.assert_close(r["loss"], loss.detach())
    torch.testing.assert_close(r["y"], Y.detach())
    torch.testing.assert_close(r["gx"], Xd.grad)
    rows, cols = A.nonzero()
    torch.testing.assert_close(r["gv"], Ad.grad[rows, cols])
    Aabs = torch.tensor(abs(A.astype(np.float32)).toarray(), dtype=torch.float64)
    torch.testing.assert_close(r["y_scale"], Aabs @ Xd.detach().abs())
    torch.testing.assert_close(r["gx_scale"], Aabs.T @ (2 * r["y_scale"]))
    low = train_step(*_t(A), X, dtype=torch.bfloat16, block=block)
    assert float((low["y"] - r["y"]).abs().max()) > 1e-4

