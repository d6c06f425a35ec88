"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a
CUDA kernel has no CPU mode).  This file imports no JAX, so it also runs on a
GPU machine without it:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up for the JAX
package's tests).  Tolerance: max |kernel - plain| <= 1e-5 * max |plain|, the
fp32 sums being taken in another order; bf16 inputs are widened to fp32 in both.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spmm_tpu_torch import ops
from spmm_tpu_torch.formats import csr_to_bsr, ell_pack
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.ops import bsr_kernel, ell_kernel

from torch_parity import rhs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_shape", [(8, 128), (16, 64), (3, 32)])
def test_k1_kernel_matches_plain(cuda, dtype, block_shape):
    A = tsyn.banded_random(1000, 300, 0.3, seed=1)
    Ab = csr_to_bsr(A, block_shape).to(cuda)
    Ab = dataclasses.replace(Ab, data=Ab.data.to(dtype))
    B = torch.from_numpy(rhs(1000, 256, 0)).to(cuda, dtype)
    n0 = bsr_kernel.launches
    Y = ops.spmm(Ab, B)
    assert bsr_kernel.launches == n0 + 1
    ref = bsr_kernel.bsr_spmm_reference(Ab, B)
    torch.cuda.synchronize()
    assert float((Y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 32, 128, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel_matches_plain(cuda, k, dtype):
    g = torch.Generator().manual_seed(k)
    cols = torch.randint(-3, 5003, (1000, 37), generator=g, dtype=torch.int32).to(cuda)
    data = torch.randn(1000, 37, generator=g).to(cuda, dtype)
    B = torch.randn(5000, k, generator=g).to(cuda, dtype)
    n0 = ell_kernel.launches
    Y = ops.ell_slab_spmm(cols, data, B)
    assert ell_kernel.launches == n0 + 1
    ref = ops.ell_slab_spmm_reference(cols, data, B)
    torch.cuda.synchronize()
    assert float((Y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_they_do_not_take(cuda):
    A = csr_to_bsr(tsyn.banded_random(256, 32, 0.5, seed=2)).to(cuda)
    with pytest.raises(TypeError):
        ops.bsr_spmm(A, torch.zeros(256, 128, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.bsr_spmm(A, torch.zeros(128, 256, device=cuda).t())
    cols = torch.zeros(4, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ops.ell_slab_spmm(cols, torch.zeros(4, 2, dtype=torch.float64, device=cuda),
                          torch.zeros(3, 8, device=cuda))
    with pytest.raises(TypeError):
        ops.ell_slab_spmm(cols.long(), torch.zeros(4, 2, device=cuda), torch.zeros(3, 8, device=cuda))
    with pytest.raises(ValueError):
        ops.ell_slab_spmm(cols.cpu(), torch.zeros(4, 2, device=cuda), torch.zeros(3, 8, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [128, 32, 1])
def test_ell_spmm_on_card_matches_scipy(cuda, k):
    A = tsyn.webgraph_like(20000, 150000, seed=0)
    E = ell_pack(A, max_len=256).to(cuda)  # leftover rows take the gather path
    assert E.n_rest_rows > 0
    B = rhs(20000, k, k)
    n0 = ell_kernel.launches
    Y = ops.ell_spmm(E, torch.from_numpy(B).to(cuda)).cpu().numpy()
    assert ell_kernel.launches == n0 + len(E.data)
    ref = A.to_scipy() @ B
    assert np.abs(Y - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [1 << 26, 20000])
def test_spgemm_on_card_is_exact(cuda, budget):
    A = tsyn.webgraph_like(5000, 30000, seed=1)
    C = ops.spgemm(A, A, device=cuda, max_expand_per_chunk=budget)
    S = A.to_scipy()
    ref = (S @ S).tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(C.indptr, ref.indptr)
    np.testing.assert_array_equal(C.indices[: C.nnz], ref.indices)
    np.testing.assert_array_equal(C.data[: C.nnz], ref.data)  # integer counts: exact
