"""The hand-written CUDA kernels against their plain PyTorch versions, and
the SpGEMM paths, the BlockedCSR SpMM, the device ELL pack and the device
reorder against scipy or the host, on the card.  Every test here is marked
``cuda`` and skips without an NVIDIA GPU (a CUDA kernel has no CPU mode).
This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up for the JAX
package's tests).  Tolerance: max |kernel - plain| <= 1e-5 * max |plain|, the
fp32 sums being taken in another order; bf16 inputs are widened to fp32 in both.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from spmm_tpu_torch import ops
from spmm_tpu_torch.config import Config
from spmm_tpu_torch.formats import CSR, csr_to_bsr, ell_pack
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


#: mixed widths: single long rows up to L = 2,048 (R = 1), empty slabs, both
#: sides of the split threshold
K2_SHAPES = [(37, 1), (0, 5), (3000, 3), (90, 64), (50, 65), (1, 2048), (1, 700), (640, 8),
             (2, 130), (0, 200), (7, 512)]


def _k2_slabs(cuda, dtype, n, seed):
    g = torch.Generator().manual_seed(seed)
    cols = [torch.randint(-3, n + 3, (R, L), generator=g, dtype=torch.int32).to(cuda)
            for R, L in K2_SHAPES]
    data = [torch.randn(R, L, generator=g).to(cuda, dtype) for R, L in K2_SHAPES]
    return cols, data


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 32, 128, 130, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_multi_slab_matches_plain(cuda, k, dtype):
    """One K2 launch over slabs of mixed widths, split long rows included,
    against the per-slab plain version; a second run is bit-identical (the
    split rows' partial sums meet in a fixed order, no atomics)."""
    cols, data = _k2_slabs(cuda, dtype, 4000, k)
    B = torch.randn(4000, k, generator=torch.Generator().manual_seed(k + 1)).to(cuda, dtype)
    memo = {}
    n0 = ell_kernel.launches
    Y = ops.ell_slabs_spmm(cols, data, B, memo=memo)
    Y2 = ops.ell_slabs_spmm(cols, data, B, memo=memo)
    assert ell_kernel.launches == n0 + 2 and len(memo) == 1
    ref = ops.ell_slabs_spmm_reference(cols, data, B, torch.empty_like(Y))
    torch.cuda.synchronize()
    assert float((Y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(Y, Y2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [128, 32, 6])
def test_k2_unaligned_b_view(cuda, k):
    """B a contiguous view one element past an aligned buffer: K2 takes its
    scalar path."""
    cols, data = _k2_slabs(cuda, torch.float32, 3000, 7)
    buf = torch.randn(3000 * k + 1, generator=torch.Generator().manual_seed(3)).to(cuda)
    B = buf[1:].view(3000, k)
    assert B.data_ptr() % 16
    Y = ops.ell_slabs_spmm(cols, data, B)
    ref = ops.ell_slabs_spmm_reference(cols, data, B, torch.empty_like(Y))
    torch.cuda.synchronize()
    assert float((Y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_shape", [(8, 128), (16, 64), (3, 32)])
def test_k1_ragged_groups_and_empty_block_rows(cuda, dtype, block_shape):
    """K1's groups of 64 // bm block rows: a ragged last group (1,003 rows),
    block rows without a stored block (the zero blocks csr_to_bsr inserts
    for them taken out again), k = 256."""
    S = tsyn.banded_random(1003, 300, 0.05, seed=4).to_scipy().tolil()
    S[200:400] = 0  # block rows with nothing stored
    A = CSR.from_scipy(S.tocsr().astype(np.float32))
    Ab = csr_to_bsr(A, block_shape)
    keep = np.nonzero(np.abs(Ab.data).sum(axis=(1, 2)) > 0)[0]  # drop the inserted zero blocks
    counts = np.bincount(Ab.block_rows[keep], minlength=Ab.nbrows)
    assert (counts == 0).any()
    Ab = dataclasses.replace(
        Ab, data=Ab.data[keep], block_cols=Ab.block_cols[keep], block_rows=Ab.block_rows[keep],
        block_indptr=np.concatenate([[0], np.cumsum(counts)]).astype(np.int32), nblocks=len(keep),
    ).to(cuda)
    Ab = dataclasses.replace(Ab, data=Ab.data.to(dtype))
    B = torch.from_numpy(rhs(A.shape[1], 256, 1)).to(cuda, dtype)
    n0 = bsr_kernel.launches
    Y = ops.bsr_spmm(Ab, B)
    assert bsr_kernel.launches == n0 + 1
    ref = bsr_kernel.bsr_spmm_reference(Ab, B)
    torch.cuda.synchronize()
    assert float((Y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    want = A.to_scipy() @ B.float().cpu().numpy()
    if dtype == torch.float32:
        assert np.abs(Y.cpu().numpy() - want).max() <= 1e-4 * np.abs(want).max()


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
    assert ell_kernel.launches == n0 + 1  # one launch over every slab
    ref = A.to_scipy() @ B
    assert np.abs(Y - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [1 << 26, 20000])
def test_spgemm_on_card_is_exact(cuda, budget):
    A = tsyn.webgraph_like(5000, 30000, seed=1)
    C = ops.spgemm_sorted(A, A, device=cuda, max_expand_per_chunk=budget)
    S = A.to_scipy()
    ref = (S @ S).tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(C.indptr, ref.indptr)
    np.testing.assert_array_equal(C.indices[: C.nnz], ref.indices)
    np.testing.assert_array_equal(C.data[: C.nnz], ref.data)  # integer counts: exact


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["pattern", "random"])
def test_slab_spgemm_on_card_is_exact(cuda, values):
    A = tsyn.webgraph_like(5000, 30000, seed=1)
    if values == "random":
        A = dataclasses.replace(A, data=rhs(1, A.nnz_pad, 5)[0])
    C = ops.spgemm(A, A, device=cuda)
    S = A.to_scipy()
    ref = (S @ S).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    np.testing.assert_array_equal(C.indptr, ref.indptr)
    np.testing.assert_array_equal(C.indices[: C.nnz], ref.indices)
    if values == "pattern":
        np.testing.assert_array_equal(C.data[: C.nnz], ref.data)  # integer counts: exact
    else:  # the merge's prefix-sum difference, as in tests/test_spgemm_slab.py
        np.testing.assert_allclose(C.data[: C.nnz], ref.data, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_slab_merge_is_deterministic_on_card(cuda):
    """Two runs of a value-mode product give bit-identical chunk outputs: the
    duplicate merge uses sorts and prefix sums, no atomics."""
    from spmm_tpu_torch.ops import slab_spgemm as ss

    A = tsyn.webgraph_like(5000, 30000, seed=2)
    A = dataclasses.replace(A, data=rhs(1, A.nnz_pad, 6)[0])
    runs = [ss.spgemm_slab_device(A, A, device=cuda, slot_budget=1 << 16)[0] for _ in range(2)]
    assert len(runs[0]) > 1
    for c1, c2 in zip(*runs):
        for x1, x2 in zip(c1, c2):
            assert torch.equal(x1, x2)
    plan = ss.spgemm_plan(A, A, device=cuda)
    for c1, c2 in zip(ss.spgemm_slab_device(A, A, plan)[0], ss.spgemm_chain_device(plan, 2)):
        for x1, x2 in zip(c1, c2):
            assert torch.equal(x1, x2)


@pytest.mark.cuda
@pytest.mark.parametrize("panel", [False, True])
def test_blocked_spmm_slab_on_card(cuda, panel):
    """One K2 launch over all v8-group buckets, and the kernel path equal to
    K2's plain version on the same view and to scipy."""
    from spmm_tpu_torch.preprocess import preprocess

    A = tsyn.webgraph_like(20000, 150000, seed=3)
    P = preprocess(A, Config(region_budget=2048, panel_rows=512)).to(cuda)
    view = ops.blocked_slab_view(P, panel=panel)
    assert all(c.is_cuda and c.dtype == torch.int32 for _, c in view[0])
    B = torch.from_numpy(rhs(20000, 128, 1)).to(cuda)
    n0 = ell_kernel.launches
    Y = ops.blocked_spmm_slab(P, B, view)
    assert ell_kernel.launches == n0 + 1 and len(view[0]) > 1
    ref = ops.blocked_spmm_slab_reference(P, B, view)
    torch.cuda.synchronize()
    assert float((Y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    want = A.to_scipy() @ B.cpu().numpy()
    assert np.abs(Y.cpu().numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.cuda
def test_device_csr_spmm_packs_on_card(cuda, monkeypatch):
    """ops.spmm on a CSR held on the card packs through ell_pack_device (the
    host ell_pack is not called) and runs K2 once over all its slabs."""
    spmm_mod = importlib.import_module("spmm_tpu_torch.ops.spmm")  # ops.spmm is the function
    A = tsyn.webgraph_like(20000, 150000, seed=4)
    Cd = ops.spgemm_slab_csr(A, A, device=cuda)
    monkeypatch.setattr(spmm_mod, "ell_pack", lambda *a, **k: pytest.fail("host ell_pack called"))
    monkeypatch.setattr(spmm_mod, "AUTO_ELL_THRESHOLD", 1)
    B = torch.from_numpy(rhs(20000, 32, 2)).to(cuda)
    n0 = ell_kernel.launches
    Y = ops.spmm(Cd, B)
    E = spmm_mod._ell_of(Cd, cuda)
    assert ell_kernel.launches == n0 + 1 and len(E.data) > 1
    assert all(t.is_cuda for t in (*E.data, *E.cols, E.perm, E.rest.data))
    S = A.to_scipy()
    want = (S @ S) @ B.cpu().numpy()
    assert np.abs(Y.cpu().numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("section", [2048, 256])
def test_bitmap_perm_device_on_card(cuda, section):
    from spmm_tpu_torch.preprocess import bitmap_perm_device, bitmap_reorder

    A = tsyn.webgraph_like(50000, 300000, seed=5)
    perm = bitmap_perm_device(A.to(cuda), section)
    assert perm.is_cuda
    np.testing.assert_array_equal(perm.cpu().numpy(), bitmap_reorder(A, section, materialize=False)[1])
