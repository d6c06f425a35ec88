"""The hand-written CUDA kernels against their plain PyTorch versions, and
the SpGEMM paths, the BlockedCSR SpMM, the device ELL pack and the device
reorder against scipy or the host, on the card.  Every test here is marked
``cuda`` and skips without an NVIDIA GPU (a CUDA kernel has no CPU mode).
This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up for the JAX
package's tests).  Tolerance: max |kernel - plain| <= 1e-5 * max |plain|, the
fp32 sums being taken in another order (1e-12 in fp64); bf16 inputs are widened
to fp32 in both.  Gradients: against the plain versions' autograd gradient and
the analytic scipy value at 1e-4 of its max, ``torch.autograd.gradcheck`` in
fp64 at a tiny size, and bit-identical repeats (no atomics in K2, K3 or K1).
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
    with pytest.raises(TypeError, match="float16"):
        ops.bsr_spmm(A, torch.zeros(256, 128, dtype=torch.float16, device=cuda))
    with pytest.raises(TypeError, match="float64"):  # fp32 blocks against an fp64 B
        ops.bsr_spmm(A, torch.zeros(256, 128, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.bsr_spmm(A, torch.zeros(128, 256, device=cuda).t())
    cols = torch.zeros(4, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="float64"):  # fp64 values against an fp32 B
        ops.ell_slab_spmm(cols, torch.zeros(4, 2, dtype=torch.float64, device=cuda),
                          torch.zeros(3, 8, device=cuda))
    with pytest.raises(TypeError, match="float16"):
        ops.ell_slab_spmm(cols, torch.zeros(4, 2, dtype=torch.float16, device=cuda),
                          torch.zeros(3, 8, dtype=torch.float16, device=cuda))
    with pytest.raises(TypeError, match="float32"):  # an fp32 accumulate of fp64 operands
        ops.ell_slab_spmm(cols, torch.zeros(4, 2, dtype=torch.float64, device=cuda),
                          torch.zeros(3, 8, dtype=torch.float64, device=cuda),
                          accum_dtype=torch.float32)
    with pytest.raises(ValueError, match="autograd"):  # out= cannot carry a gradient
        ops.ell_slab_spmm(cols, torch.zeros(4, 2, device=cuda),
                          torch.zeros(3, 8, device=cuda, requires_grad=True),
                          out=torch.zeros(4, 8, device=cuda))
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


# ---- fp64 on the kernels, K3, and the backward routes --------------------------


def _rel(y, ref):
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 32, 128, 130, 256])
def test_k2_fp64_matches_plain(cuda, k):
    """fp64 values times an fp64 B on K2 (2 doubles a lane, or 1), split rows
    included, against the plain version at 1e-12; the output is fp64."""
    cols, data = _k2_slabs(cuda, torch.float64, 4000, k)
    B = torch.randn(4000, k, generator=torch.Generator().manual_seed(k), dtype=torch.float64).to(cuda)
    n0 = ell_kernel.launches
    Y = ops.ell_slabs_spmm(cols, data, B)
    assert ell_kernel.launches == n0 + 1 and Y.dtype == torch.float64
    ref = ops.ell_slabs_spmm_reference(cols, data, B, torch.empty_like(Y))
    torch.cuda.synchronize()
    assert _rel(Y, ref) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("block_shape", [(8, 128), (16, 64), (3, 32)])
def test_k1_fp64_matches_plain(cuda, block_shape):
    A = tsyn.banded_random(1000, 300, 0.3, seed=1, dtype=np.float64)
    Ab = csr_to_bsr(A, block_shape).to(cuda)
    B = torch.from_numpy(rhs(1000, 256, 0).astype(np.float64)).to(cuda)
    n0 = bsr_kernel.launches
    Y = ops.spmm(Ab, B)
    assert bsr_kernel.launches == n0 + 1 and Y.dtype == torch.float64
    ref = bsr_kernel.bsr_spmm_reference(Ab, B)
    torch.cuda.synchronize()
    assert _rel(Y, ref) <= 1e-12
    want = A.to_scipy() @ B.cpu().numpy()
    assert np.abs(Y.cpu().numpy() - want).max() <= 1e-12 * np.abs(want).max()


#: K3's slot-major walk: rows of L = 1, 2, 3, 31, 33, 64, 65 and longer than
#: the split threshold, R not a multiple of any step, an empty slab
K3_SHAPES = [(1037, 1), (555, 2), (333, 3), (77, 31), (45, 33), (20, 64), (19, 65), (3, 700), (0, 9),
             (1, 1), (2, 130)]


def _k3_slabs(cuda, shapes, n, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(-3, n + 3, (R, L), generator=g, dtype=torch.int32).to(cuda) for R, L in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", ["k2", "k3"])
@pytest.mark.parametrize("k", [1, 3, 32, 128, 130, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_k3_kernel_matches_plain(cuda, shapes, k, dtype):
    """K3 (the slab values' gradient) in one launch over mixed slabs (K2's
    test shapes, or ``K3_SHAPES``) against its plain version; a second run is
    bit-identical."""
    cols = _k3_slabs(cuda, K2_SHAPES if shapes == "k2" else K3_SHAPES, 4000, k)
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    g = torch.Generator().manual_seed(k + 7)
    B = torch.randn(4000, k, generator=g, dtype=acc).to(cuda, dtype)
    rows = sum(c.shape[0] for c in cols)
    dY = torch.randn(rows, k, generator=g, dtype=acc).to(cuda)
    n0 = ell_kernel.sddmm_launches
    out = ops.ell_slabs_sddmm(cols, dY, B)
    out2 = ops.ell_slabs_sddmm(cols, dY, B)
    assert ell_kernel.sddmm_launches == n0 + 2
    ref = ops.ell_slabs_sddmm_reference(cols, dY, B)
    torch.cuda.synchronize()
    tol = 1e-12 if acc == torch.float64 else 1e-5
    scale = max(float(r.abs().max()) for r in ref if r.numel())
    for o, o2, r in zip(out, out2, ref, strict=True):
        assert o.shape == r.shape and o.dtype == acc
        if r.numel():
            assert float((o - r).abs().max()) <= tol * scale
        assert torch.equal(o, o2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_on_transposed_pack(cuda, k, dtype):
    """Aᵀ · dY as one K2 launch over the transposed pack, rows cut into
    pieces included, against its plain version and against the dense Aᵀ."""
    A = tsyn.webgraph_like(20000, 150000, seed=6)
    E = ell_pack(A).to(cuda)
    data = [d.to(dtype) for d in E.data]
    rows = sum(c.shape[0] for c in E.cols)
    dY = torch.randn(rows, k, generator=torch.Generator().manual_seed(k), dtype=dtype).to(cuda)
    # cut at 128, so that the hubs of this small graph get cut
    memo = {("transposed", dY.device, A.shape[1]): ops.transposed_slabs(E.cols, A.shape[1], dY.device, cut=128)}
    n0, t0 = ell_kernel.launches, ell_kernel.transposed_launches
    g = ops.ell_slabs_spmm_transposed(E.cols, data, dY, A.shape[1], memo=memo)
    g2 = ops.ell_slabs_spmm_transposed(E.cols, data, dY, A.shape[1], memo=memo)
    assert ell_kernel.launches == n0 + 2 and ell_kernel.transposed_launches == t0 + 2
    T = memo[("transposed", dY.device, A.shape[1])]
    assert T.hub_rows.numel() > 0
    ref = ops.ell_slabs_spmm_transposed_reference(E.cols, data, dY, A.shape[1], memo=memo)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _rel(g, ref) <= tol and torch.equal(g, g2)
    # the slab rows are A's rows in length-sorted order
    perm = E.perm.cpu().numpy()[E.n_empty : A.shape[0] - E.n_rest_rows]
    want = A.to_scipy()[perm].T.astype(np.float64) @ dY.double().cpu().numpy()
    assert np.abs(g.cpu().numpy() - want).max() <= max(tol, 1e-5 if dtype == torch.float32 else 0) * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("block_shape", [(8, 128), (16, 64), (3, 32), (4, 256), (8, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, "bf16 blocks", "bf16 dY", torch.bfloat16])
def test_k1_on_transposed_bsr(cuda, block_shape, dtype):
    """The transposed kernel, A's own blocks read in place (no re-blocked Aᵀ,
    no value gather): one launch of it and none of K1, against its plain
    version (fp32 1e-5, fp64 1e-12, bf16 operands widened alike) and scipy;
    bn above 128 takes parts of 128 rows, bn = 6 its element-wise staging."""
    A = tsyn.banded_random(1003, 300, 0.3, seed=2, dtype=np.float64)
    Ab = csr_to_bsr(A, block_shape).to(cuda)
    ddt = {"bf16 blocks": torch.bfloat16, "bf16 dY": torch.float32}.get(dtype, dtype)
    ydt = {"bf16 blocks": torch.float32, "bf16 dY": torch.bfloat16}.get(dtype, dtype)
    Ab = dataclasses.replace(Ab, data=Ab.data.to(ddt))
    dY = torch.from_numpy(rhs(1003, 256, 3)).to(cuda, ydt)
    n0, t0 = bsr_kernel.launches, bsr_kernel.transposed_launches
    g = ops.bsr_spmm_transposed(Ab, dY)
    g2 = ops.bsr_spmm_transposed(Ab, dY)
    assert bsr_kernel.launches == n0 and bsr_kernel.transposed_launches == t0 + 2
    assert set(Ab.__dict__) & {"_k1_plans", "_k1t_plans"} == {"_k1t_plans"}  # its plan alone, no K1
    ref = ops.bsr_spmm_transposed_reference(Ab, dY)
    torch.cuda.synchronize()
    assert g.dtype == (torch.float64 if dtype == torch.float64 else torch.float32)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _rel(g, ref) <= tol and torch.equal(g, g2)
    if ddt != torch.bfloat16 and ydt != torch.bfloat16:
        want = A.to_scipy().T @ dY.double().cpu().numpy()
        assert np.abs(g.cpu().numpy() - want).max() <= (tol if dtype == torch.float64 else 1e-4) * np.abs(want).max()


def _analytic(A, B0):
    S = A.to_scipy().astype(np.float64)
    return 2.0 * (S.T @ (S @ B0.astype(np.float64)))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["ell", "ell_rest", "bsr", "blocked", "csr_large", "csr_small"])
def test_backward_through_ops_spmm_on_card(cuda, form, monkeypatch):
    """d/dB sum((A B)^2) = 2 Aᵀ A B through every format of ``ops.spmm`` with
    CUDA tensors: the full gradient, none of it dropped."""
    from spmm_tpu_torch.preprocess import preprocess

    spmm_mod = importlib.import_module("spmm_tpu_torch.ops.spmm")
    k = 128
    if form == "bsr":
        A = tsyn.banded_random(2048, 200, 0.3, seed=5)
        M = csr_to_bsr(A).to(cuda)
    else:
        A = tsyn.webgraph_like(20000, 150000, seed=7)
        if form == "ell":
            M = ell_pack(A).to(cuda)
        elif form == "ell_rest":
            M = ell_pack(A, max_len=256).to(cuda)
            assert M.n_rest_rows > 0
        elif form == "blocked":
            M = preprocess(A, Config(region_budget=2048, panel_rows=512)).to(cuda)
        else:
            monkeypatch.setattr(spmm_mod, "AUTO_ELL_THRESHOLD", 1 if form == "csr_large" else 1 << 30)
            M = A
    B0 = rhs(A.shape[1], k, 8)
    B = torch.from_numpy(B0).to(cuda).requires_grad_()
    n2, n1 = ell_kernel.transposed_launches, bsr_kernel.transposed_launches
    (ops.spmm(M, B) ** 2).sum().backward()
    torch.cuda.synchronize()
    if form == "bsr":
        assert bsr_kernel.transposed_launches == n1 + 1
    elif form != "csr_small":
        assert ell_kernel.transposed_launches == n2 + 1
    ref = _analytic(A, B0)
    assert np.abs(B.grad.cpu().numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_spmm_backward_launches_and_values_grad(cuda, dtype):
    """One K2 forward launch, one K2 launch on the transposed pack and one K3
    launch per backward; both gradients against the analytic values; a second
    backward is bit-identical; without grad the forward is one launch into
    the output itself."""
    A = tsyn.webgraph_like(20000, 150000, seed=9)
    if dtype == torch.float64:
        A = dataclasses.replace(A, data=A.data.astype(np.float64))
    E = ell_pack(A).to(cuda)
    E = dataclasses.replace(E, data=tuple(d.requires_grad_() for d in E.data))
    B0 = rhs(20000, 32, 4)
    B = torch.from_numpy(B0).to(cuda, dtype).requires_grad_()
    grads = []
    for _ in range(2):
        c0 = (ell_kernel.launches, ell_kernel.transposed_launches, ell_kernel.sddmm_launches)
        Y = ops.ell_spmm(E, B, accum_dtype=dtype)
        assert ell_kernel.launches == c0[0] + 1 and Y.dtype == dtype
        gB, *gD = torch.autograd.grad((Y ** 2).sum(), [B, *E.data])
        c1 = (ell_kernel.launches, ell_kernel.transposed_launches, ell_kernel.sddmm_launches)
        assert tuple(b - a for a, b in zip(c0, c1)) == (2, 1, 1)
        grads.append((gB, gD))
    torch.cuda.synchronize()
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    ref = _analytic(A, B0)
    assert np.abs(grads[0][0].cpu().numpy() - ref).max() <= tol * np.abs(ref).max()
    # d/dv_e = 2 Y[row_e] . B[col_e], slot by slot of each slab
    S = A.to_scipy().astype(np.float64)
    Yh = S @ B0.astype(np.float64)
    perm = E.perm.cpu().numpy()
    row = E.n_empty
    for c, g in zip(E.cols, grads[0][1]):
        R = c.shape[0]
        want = 2.0 * np.einsum("rk,rlk->rl", Yh[perm[row : row + R]], B0.astype(np.float64)[c.cpu().numpy()])
        assert np.abs(g.cpu().numpy() - want).max() <= tol * max(np.abs(want).max(), 1.0)
        row += R
    with torch.no_grad():
        n0 = ell_kernel.launches
        ops.ell_spmm(E, B, accum_dtype=dtype)
        assert ell_kernel.launches == n0 + 1


@pytest.mark.cuda
def test_bsr_spmm_backward_on_card(cuda):
    A = tsyn.banded_random(2048, 200, 0.3, seed=11)
    Ab = csr_to_bsr(A).to(cuda)
    data = Ab.data.clone().requires_grad_()
    Ab = dataclasses.replace(Ab, data=data)
    B0 = rhs(2048, 128, 12)
    B = torch.from_numpy(B0).to(cuda).requires_grad_()
    gB, gD = torch.autograd.grad((ops.bsr_spmm(Ab, B) ** 2).sum(), [B, data])
    gB2, gD2 = torch.autograd.grad((ops.bsr_spmm(Ab, B) ** 2).sum(), [B, data])
    Bc = B.detach().clone().requires_grad_()
    dc = data.detach().clone().requires_grad_()
    rB, rD = torch.autograd.grad(
        (bsr_kernel.bsr_spmm_reference(dataclasses.replace(Ab, data=dc), Bc) ** 2).sum(), [Bc, dc])
    torch.cuda.synchronize()
    assert torch.equal(gB, gB2) and torch.equal(gD, gD2)
    assert _rel(gB, rB) <= 1e-4 and _rel(gD, rD) <= 1e-4
    ref = _analytic(A, B0)
    assert np.abs(gB.cpu().numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.cuda
def test_gradcheck_fp64_on_card(cuda):
    """``torch.autograd.gradcheck`` of the kernels' Functions in fp64 at a
    tiny size: K2 w.r.t. B and the slab values, K1 w.r.t. B and the blocks."""
    g = torch.Generator().manual_seed(0)
    shapes = [(5, 3), (2, 70), (4, 1)]
    cols = [torch.randint(0, 12, s, generator=g, dtype=torch.int32).to(cuda) for s in shapes]
    data = [torch.randn(s, generator=g, dtype=torch.float64).to(cuda).requires_grad_() for s in shapes]
    B = torch.randn(12, 6, generator=g, dtype=torch.float64).to(cuda).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda B, *d: ops.ell_slabs_spmm(cols, d, B), (B, *data), eps=1e-6, atol=1e-8)
    A = tsyn.banded_random(40, 12, 0.5, seed=3, dtype=np.float64)
    Ab = csr_to_bsr(A, (8, 16)).to(cuda)
    blocks = Ab.data.clone().requires_grad_()
    Bk = torch.randn(40, 128, generator=g, dtype=torch.float64).to(cuda).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda B, d: ops.bsr_spmm(dataclasses.replace(Ab, data=d), B), (Bk, blocks),
        eps=1e-6, atol=1e-8)


@pytest.mark.cuda
def test_blocked_spmm_slab_backward_on_card(cuda):
    """The packed format's gradient w.r.t. B on the card against its plain
    version's and the analytic value; two runs bit-identical in the K2 part
    (the leftover stream's ``index_add_`` is atomic in PyTorch)."""
    from spmm_tpu_torch.preprocess import preprocess

    A = tsyn.webgraph_like(20000, 150000, seed=3)
    P = preprocess(A, Config(region_budget=2048, panel_rows=512)).to(cuda)
    view = ops.blocked_slab_view(P)
    B0 = rhs(20000, 128, 1)
    B = torch.from_numpy(B0).to(cuda).requires_grad_()
    t0 = ell_kernel.transposed_launches
    (g,) = torch.autograd.grad((ops.blocked_spmm_slab(P, B, view) ** 2).sum(), [B])
    assert ell_kernel.transposed_launches == t0 + 1
    (r,) = torch.autograd.grad((ops.blocked_spmm_slab_reference(P, B, view) ** 2).sum(), [B])
    torch.cuda.synchronize()
    assert _rel(g, r) <= 1e-4
    ref = _analytic(A, B0)
    assert np.abs(g.cpu().numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["ell", "bsr"])
def test_backward_bf16_on_card(cuda, form):
    """bf16 values and B: the forward sums in fp32, the gradients come back in
    bf16 (K2 / K1 on the transposed structure with bf16 values, K3 with a
    bf16 B), against the fp32 plain versions' autograd gradient at the bf16
    bound."""
    k = 128
    if form == "ell":
        A = tsyn.webgraph_like(20000, 150000, seed=13)
        E = ell_pack(A).to(cuda)
        data = tuple(d.bfloat16().requires_grad_() for d in E.data)
        M = dataclasses.replace(E, data=data)
        fn = lambda M, B: ops.ell_spmm(M, B)
        plain = lambda d, B: ops.ell_slabs_spmm_reference(E.cols, d, B, torch.empty(
            (sum(c.shape[0] for c in E.cols), k), device=cuda))
    else:
        A = tsyn.banded_random(2048, 200, 0.3, seed=14)
        Ab = csr_to_bsr(A).to(cuda)
        data = (Ab.data.bfloat16().requires_grad_(),)
        M = dataclasses.replace(Ab, data=data[0])
        fn = lambda M, B: ops.bsr_spmm(M, B)
        plain = lambda d, B: bsr_kernel.bsr_spmm_reference(dataclasses.replace(Ab, data=d[0]), B)
    B = torch.from_numpy(rhs(A.shape[1], k, 15)).to(cuda).bfloat16().requires_grad_()
    Y = fn(M, B)
    assert Y.dtype == torch.float32
    gB, *gD = torch.autograd.grad((Y ** 2).sum(), [B, *data])
    assert gB.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in gD)
    # the reference: the same bf16 values widened to fp32 first (autograd of
    # the bf16 plain version would add the hub columns' shares up in bf16)
    Bp = B.detach().float().requires_grad_()
    dp = tuple(d.detach().float().requires_grad_() for d in data)
    rB, *rD = torch.autograd.grad((plain(dp, Bp) ** 2).sum(), [Bp, *dp])
    torch.cuda.synchronize()
    assert _rel(gB.float(), rB) <= 2e-2
    scale = max(float(r.abs().max()) for r in rD)
    for g, r in zip(gD, rD, strict=True):
        assert float((g.float() - r).abs().max()) <= 2e-2 * scale


# ---- slice 6: ordered sums (F6), K1's dtype mixes (F7), the maps of K2 / K3 ----


#: the ordered sum's cases: (name, k values); the original 20,000-row hub
#: among 500 segments sorted and unsorted, and the shapes of its chunked
#: design (ops/segments.py: chunk_layout) -- a hub of 300,000 rows among short
#: segments, boundaries on chunk edges with a segment over >= 3 chunks and
#: empty segments at the edges and the end, offsets[0] > 0 with rows after
#: the last segment, an unsorted order with a hub, 4M segments of 1-3 rows
SEG_CASES = [(case, k) for case in ("hub20k_sorted", "hub20k_unsorted") for k in (1, 3, 4, 8, 128, 130, 300)] + [
    (case, k) for case in ("hub300k", "chunk_edges", "offset0", "unsorted_hub", "tiny4m") for k in (1, 4, 128, 130)]


def _segment_case(case, k, dtype, dev):
    """(data, plan) of one case, the data made on the card from a seed."""
    from spmm_tpu_torch.ops import segments

    rng = np.random.default_rng(k)
    if case.startswith("hub20k"):
        ids = rng.integers(-2, 502, 60_000)
        ids[:20_000] = 7
        sort = case.endswith("_sorted")
        if sort:
            ids = np.sort(ids)
        plan = segments.segment_plan(torch.from_numpy(ids).to(dev), 500, indices_are_sorted=sort)
        n = ids.size
    elif case == "unsorted_hub":
        ids = rng.integers(0, 300, 400_000)
        ids[rng.choice(400_000, 200_000, replace=False)] = 42
        plan = segments.segment_plan(torch.from_numpy(ids).to(dev), 300)
        n = ids.size
    else:
        start, tail = 0, 0
        if case == "hub300k":
            lens = rng.integers(1, 6, 20_000)
            lens[7777] = 300_000
        elif case == "chunk_edges":
            kt, ct, ipt = segments.chunk_layout(k, torch.empty((), dtype=dtype).element_size())
            P = (segments.THREADS // ct) * ipt
            # edges at P, 2P, 5P (empty segments there too), one segment over
            # chunks 2-4 from an edge, one over >= 3 chunks from mid-chunk
            lens = np.concatenate([[P, 0, 0, P // 2, P // 2, 0, 3 * P, 0, 7, 3 * P + 5],
                                   rng.integers(1, 9, 500), [0, 0, 0]])
        elif case == "offset0":
            lens = rng.integers(0, 40, 3000)
            start, tail = 1000, 777
        else:  # tiny4m
            lens = rng.integers(1, 4, 4_000_000)
            lens[rng.choice(4_000_000, 1000, replace=False)] = 0
        offsets = start + np.concatenate([[0], np.cumsum(lens)])
        plan = segments.offsets_plan(torch.from_numpy(offsets).to(dev), dev)
        n = int(offsets[-1]) + tail
    g = torch.Generator(device=dev).manual_seed(k)
    if dtype.is_floating_point:
        data = torch.randn((n, k), generator=g, device=dev, dtype=dtype) * 100
    else:
        data = torch.randint(-1000, 1000, (n, k), generator=g, device=dev, dtype=dtype)
    return data, plan


@pytest.mark.cuda
@pytest.mark.parametrize("case,k", SEG_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32, torch.int64])
def test_segment_sum_kernel_matches_plain(cuda, case, k, dtype):
    """The ordered-sum kernel against its plain version (fp32 1e-5, fp64
    1e-12 of max, integers exact) on every case of ``SEG_CASES``; three runs
    equal in their bits.  Floats are held to the plain version taken in
    fp64: ``torch.segment_reduce`` adds a segment's rows one by one, and in
    fp32 over a hub of 20,000 rows its own rounding reaches ~1e-5 of max."""
    from spmm_tpu_torch.ops import segments

    data, plan = _segment_case(case, k, dtype, cuda)
    n0 = segments.launches
    runs = [segments.segment_sum(data, plan=plan) for _ in range(3)]
    assert segments.launches == n0 + 3
    ref = segments.segment_sum_reference(data.double() if dtype == torch.float32 else data, plan)
    torch.cuda.synchronize()
    assert runs[0].shape == ref.shape == (plan.num_segments, k) and runs[0].dtype == dtype
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    if not dtype.is_floating_point:
        assert torch.equal(runs[0], ref)
    else:
        assert _rel(runs[0].to(ref.dtype), ref) <= (1e-12 if dtype == torch.float64 else 1e-5)


def _thrice(fn):
    """Three runs of ``fn`` on the card, equal in their bits; the first."""
    runs = [fn() for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:]), "runs differ in their bits"
    return runs[0]


@pytest.mark.cuda
def test_f6_sites_bit_identical_on_card(cuda):
    """Every product that went through ``index_add_`` (atomic on CUDA): three
    runs give the same bits, and each is held against scipy (1e-4 of max)."""
    from spmm_tpu_torch.preprocess import preprocess

    A = tsyn.webgraph_like(20000, 150000, seed=21)
    S = A.to_scipy().astype(np.float64)
    B0 = rhs(20000, 64, 22)
    B = torch.from_numpy(B0).to(cuda)
    x = B[:, 0].contiguous()
    close = lambda y, ref: np.abs(y.cpu().numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    E = ell_pack(A, max_len=128).to(cuda)
    assert E.n_rest_rows > 0
    assert close(_thrice(lambda: ops.ell_spmm(E, B)), S @ B0)
    assert close(_thrice(lambda: ops.ell_spmv(E, x)), S @ B0[:, 0])
    assert close(_thrice(lambda: ops.spmm_xla(A.pad(8).to(cuda), B)), S @ B0)
    P = preprocess(A, Config(region_budget=2048, panel_rows=512)).to(cuda)
    view = ops.blocked_slab_view(P)
    assert close(_thrice(lambda: ops.blocked_spmm_slab(P, B, view)), S @ B0)
    assert close(_thrice(lambda: ops.blocked_spmm_xla(P, B, view=ops.blocked_exec_view(P))), S @ B0)
    assert close(_thrice(lambda: ops.blocked_spmm_panel(P, B)), S @ B0)
    assert close(_thrice(lambda: ops.blocked_chain_spmv(P, x, 2)), S @ (S @ B0[:, 0]))
    Ab = tsyn.banded_random(4096, 300, 0.3, seed=23)
    xb = torch.from_numpy(rhs(1, 4096, 24)[0]).to(cuda)
    assert close(_thrice(lambda: ops.bsr_spmv(csr_to_bsr(Ab).to(cuda), xb)),
                 Ab.to_scipy() @ xb.double().cpu().numpy())
    Av = dataclasses.replace(A, data=rhs(1, A.nnz_pad, 25)[0] * (np.arange(A.nnz_pad) < A.nnz))
    Cs = [ops.spgemm_sorted(Av, Av, device=cuda) for _ in range(3)]
    assert all(np.array_equal(np.asarray(Cs[0].data), np.asarray(c.data)) for c in Cs[1:])
    ref = (Av.to_scipy() @ Av.to_scipy()).tocsr()
    ref.sort_indices()
    assert np.abs(np.asarray(Cs[0].data[: Cs[0].nnz]) - ref.data).max() <= 1e-4 * np.abs(ref.data).max()


@pytest.mark.cuda
@pytest.mark.parametrize("block_shape", [(8, 128), (16, 64), (3, 32)])
@pytest.mark.parametrize("mix", [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_k1_dtype_mixes(cuda, block_shape, mix):
    """fp32 blocks × bf16 B and the reverse, with no cast of the blocks: one
    launch, fp32 output, against the plain version at 1e-5 (both widen the
    same bf16 values)."""
    A = tsyn.banded_random(1000, 300, 0.3, seed=26)
    Ab = csr_to_bsr(A, block_shape).to(cuda)
    Ab = dataclasses.replace(Ab, data=Ab.data.to(mix[0]))
    B = torch.from_numpy(rhs(1000, 256, 27)).to(cuda, mix[1])
    n0 = bsr_kernel.launches
    Y = ops.spmm(Ab, B)
    assert bsr_kernel.launches == n0 + 1 and Y.dtype == torch.float32
    ref = bsr_kernel.bsr_spmm_reference(Ab, B)
    torch.cuda.synchronize()
    assert _rel(Y, ref) <= 1e-5


@pytest.mark.cuda
def test_k1_k_tile(cuda):
    A = tsyn.banded_random(1000, 300, 0.3, seed=28)
    Ab = csr_to_bsr(A).to(cuda)
    B = torch.from_numpy(rhs(1000, 512, 29)).to(cuda)
    ref = bsr_kernel.bsr_spmm_reference(Ab, B)
    for tile in (128, 256, 512):
        assert _rel(ops.spmm(Ab, B, k_tile=tile, interpret=False), ref) <= 1e-5
    with pytest.raises(ValueError, match="k=384 must be a multiple of k_tile=256"):
        ops.spmm(Ab, B[:, :384].contiguous(), k_tile=256)


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", ["k2", "k3"])
@pytest.mark.parametrize("k", [1, 3, 32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_k2_k3_row_map_match_plain(cuda, shapes, k, dtype):
    """K2 with its row map (slab rows written at permuted rows) and K3 reading
    dY through it, against their plain versions (K2's test shapes, or
    ``K3_SHAPES``); the rows no slab row maps to are left as they were, and
    K3 gives the same bits twice."""
    shp = K2_SHAPES if shapes == "k2" else K3_SHAPES
    cols = _k3_slabs(cuda, shp, 4000, 30 + k)
    g = torch.Generator().manual_seed(31 + k)
    data = [torch.randn(R, L, generator=g).to(cuda, dtype) for R, L in shp]
    rows = sum(c.shape[0] for c in cols)
    g = torch.Generator().manual_seed(k)
    out_rows = (torch.randperm(rows + 50, generator=g)[:rows]).to(torch.int32).to(cuda)
    bdt = torch.float64 if dtype == torch.float64 else dtype
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    B = torch.randn(4000, k, generator=g, dtype=torch.float64).to(cuda, bdt)
    n0 = ell_kernel.launches
    Y = torch.full((rows + 50, k), 7.0, dtype=acc, device=cuda)
    ell_kernel._k2_launch(cols, data, B, Y, None, None, out_rows=out_rows)
    assert ell_kernel.launches == n0 + 1
    ref = torch.full_like(Y, 7.0)
    ops.ell_slabs_spmm_reference(cols, data, B, ref, accum_dtype=acc, out_rows=out_rows)
    dY = torch.randn(rows + 50, k, generator=g, dtype=torch.float64).to(cuda, acc)
    gd = ops.ell_slabs_sddmm(cols, dY, B, out_rows=out_rows)
    gd2 = ops.ell_slabs_sddmm(cols, dY, B, out_rows=out_rows)
    gr = ell_kernel.ell_slabs_sddmm_reference(cols, dY, B, out_rows=out_rows)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _rel(Y, ref) <= tol
    scale = max(float(r.abs().max()) for r in gr if r.numel())
    assert all(float((a - b).abs().max()) <= tol * scale for a, b in zip(gd, gr, strict=True) if b.numel())
    assert all(torch.equal(a, b) for a, b in zip(gd, gd2, strict=True))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_k2_transposed_with_row_map_and_value_index(cuda, k, dtype):
    """grad B of ``ell_spmm``: one K2 launch over the mapped transposed pack
    (values read through the value index, dY at the original rows, cut rows'
    pieces in scratch rows) against its plain version and scipy; repeats
    bit-identical."""
    A = tsyn.webgraph_like(20000, 150000, seed=31)
    E = ell_pack(A, max_len=256).to(cuda)
    data = [d.to(dtype) for d in E.data]
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    dY = torch.randn(20000, k, generator=torch.Generator().manual_seed(k), dtype=torch.float64).to(cuda, acc)
    perm = E.perm.long()
    out_rows = perm[E.n_empty : 20000 - E.n_rest_rows].to(torch.int32)
    T = ops.transposed_slabs(E.cols, 20000, cuda, cut=128, out_rows=out_rows)
    assert T.scratch > 0 and T.empty_rows.numel() > 0
    memo = {("transposed", cuda, 20000, "rows"): T}
    n0, t0 = ell_kernel.launches, ell_kernel.transposed_launches
    g = ops.ell_slabs_spmm_transposed(E.cols, data, dY, 20000, memo=memo, out_rows=out_rows)
    g2 = ops.ell_slabs_spmm_transposed(E.cols, data, dY, 20000, memo=memo, out_rows=out_rows)
    assert ell_kernel.launches == n0 + 2 and ell_kernel.transposed_launches == t0 + 2
    ref = ops.ell_slabs_spmm_transposed_reference(E.cols, data, dY, 20000, memo=memo, out_rows=out_rows)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _rel(g, ref) <= tol and torch.equal(g, g2)
    if dtype != torch.bfloat16:
        rows = perm.cpu().numpy()[E.n_empty : 20000 - E.n_rest_rows]
        want = A.to_scipy()[rows].T.astype(np.float64) @ dY.double().cpu().numpy()[rows]
        assert np.abs(g.double().cpu().numpy() - want).max() <= max(tol, 1e-5) * np.abs(want).max()


@pytest.mark.cuda
def test_ell_spmm_row_map_on_card(cuda):
    """``ell_spmm`` writes every row in place: one K2 launch and no gather of
    the whole output; with grad, one K2 on the transposed pack per backward
    (none of the forward's gathers in it), the leftover rows' share through
    the ordered sum; against scipy."""
    A = tsyn.webgraph_like(20000, 150000, seed=32)
    E = ell_pack(A, max_len=256).to(cuda)
    assert E.n_rest_rows > 0 and E.n_empty > 0
    B0 = rhs(20000, 128, 33)
    B = torch.from_numpy(B0).to(cuda).requires_grad_()
    S = A.to_scipy().astype(np.float64)
    for _ in range(2):
        c0 = (ell_kernel.launches, ell_kernel.transposed_launches)
        Y = ops.ell_spmm(E, B)
        (gB,) = torch.autograd.grad((Y ** 2).sum(), [B])
        c1 = (ell_kernel.launches, ell_kernel.transposed_launches)
        assert (c1[0] - c0[0], c1[1] - c0[1]) == (2, 1)
    ref = S @ B0
    assert np.abs(Y.detach().cpu().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    want = 2.0 * (S.T @ ref)
    assert np.abs(gB.cpu().numpy() - want).max() <= 1e-4 * np.abs(want).max()
    shapes, real = [], torch.Tensor.index_select
    def spy(t, *a, **kw):
        out = real(t, *a, **kw)
        shapes.append(tuple(out.shape))
        return out

    torch.Tensor.index_select = spy
    try:
        with torch.no_grad():
            ops.ell_spmm(E, B)
    finally:
        torch.Tensor.index_select = real
    assert (20000, 128) not in shapes  # no un-permute of the output


# ---------------------------------------------------------------------------
# the distributed entry points on one card: NCCL at world size 1 (the
# collectives degenerate, the kernels and their launches are real)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import socket

    import torch.distributed as dist

    from spmm_tpu_torch.parallel import make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)  # the rank's device, before the mesh's communicator
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spmm_dist", "spmm_dist_ring", "spmv_dist", "spmm_dist_colsplit"])
def test_dist_spmm_at_world_size_1_on_card(nccl_mesh, name, monkeypatch):
    """Each distributed SpMM runs its shard through K2 (one launch; the pack
    threshold lowered as a shard above it takes that route at full size) and
    matches the same product through K2's plain version on the CPU."""
    from spmm_tpu_torch import parallel
    from spmm_tpu_torch.parallel.partition import local_shard

    spmm_mod = importlib.import_module("spmm_tpu_torch.ops.spmm")
    monkeypatch.setattr(spmm_mod, "AUTO_ELL_THRESHOLD", 0)
    A = tsyn.webgraph_like(2000, 14000, seed=0)
    S = parallel.partition_cols(A, 1) if name == "spmm_dist_colsplit" else parallel.partition_rows(A, 1)
    B = torch.from_numpy(rhs(2000, 16, 0))
    Bx = B[:, 0].contiguous() if name == "spmv_dist" else B
    n0 = ell_kernel.launches
    Y = getattr(parallel, name)(S, Bx.to(nccl_mesh.device_type), nccl_mesh)
    assert ell_kernel.launches == n0 + 1
    L = local_shard(S, 0, "cpu")
    ref = ops.spmm(L, Bx[:, None] if name == "spmv_dist" else Bx)
    ref = ref[:, 0] if name == "spmv_dist" else ref
    torch.cuda.synchronize()
    assert Y.shape == (1,) + tuple(ref.shape) and Y.is_cuda
    assert float((Y[0].cpu() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pattern", "tail"])
def test_dist_spgemm_at_world_size_1_on_card(nccl_mesh, case):
    """``spgemm_dist_spmd`` and ``spgemm_dist_csr`` on the card: A×A's
    structure equal to scipy's, counts exact (values 1e-4 of max with a tail
    row through the ESC)."""
    import scipy.sparse as sp

    from spmm_tpu_torch import parallel

    if case == "pattern":
        A, kw = tsyn.webgraph_like(2400, 12000, seed=17), {}
    else:
        M = sp.random(600, 600, density=0.01, random_state=3, format="lil", dtype=np.float32)
        M[5, :] = np.random.default_rng(3).standard_normal(600)
        A, kw = CSR.from_scipy(M.tocsr()), {"classes": (4, 8, 16)}
    ref = (A.to_scipy() @ A.to_scipy()).tocsr()
    ref.sort_indices()
    S = parallel.partition_rows(A, 1)
    outs = [parallel.spgemm_dist_spmd(S, A, nccl_mesh, **kw)]
    if case == "pattern":
        G = parallel.spgemm_dist_csr(S, A, nccl_mesh, **kw)
        assert G.data.is_cuda and G.nnz == ref.nnz
        outs.append(parallel.unshard_csr_rows(G))
    else:
        with pytest.raises(ValueError, match="heavy-tail"):
            parallel.spgemm_dist_csr(S, A, nccl_mesh, **kw)
    for C in outs:
        assert C.nnz == ref.nnz
        np.testing.assert_array_equal(np.asarray(C.indptr, np.int64), ref.indptr)
        np.testing.assert_array_equal(C.indices[: C.nnz], ref.indices)
        np.testing.assert_allclose(C.data[: C.nnz], ref.data, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_dist_refuses_host_tensors_on_nccl(nccl_mesh):
    """A CPU mesh on NCCL, or a CPU B on a CUDA mesh, raises: no silent copy
    through the host."""
    from spmm_tpu_torch import parallel

    with pytest.raises(ValueError, match="gloo"):
        parallel.make_mesh(device="cpu")
    S = parallel.partition_rows(tsyn.random_csr(64, 64, 0.1, seed=0), 1)
    with pytest.raises(ValueError, match="lies on cpu"):
        parallel.spmm_dist(S, torch.zeros((64, 4)), nccl_mesh)


def _dist_case(case):
    """(A, keywords) of the card's distributed SpGEMM tests."""
    import scipy.sparse as sp

    if case == "pattern":
        return tsyn.webgraph_like(2400, 12000, seed=17), {}
    if case == "values":
        A = tsyn.webgraph_like(2400, 12000, seed=17)
        vals = np.random.default_rng(17).standard_normal(A.data.shape).astype(np.float32)
        return dataclasses.replace(A, data=vals), {}
    M = sp.random(600, 600, density=0.01, random_state=3, format="lil", dtype=np.float32)
    M[5, :] = np.random.default_rng(3).standard_normal(600)
    return CSR.from_scipy(M.tocsr()), {"classes": (4, 8, 16)}


def _exact(C, ref):
    assert C.nnz == ref.nnz
    np.testing.assert_array_equal(np.asarray(C.indptr, np.int64), ref.indptr)
    np.testing.assert_array_equal(C.indices[: C.nnz], ref.indices)
    np.testing.assert_allclose(C.data[: C.nnz], ref.data, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pattern", "values", "tail"])
def test_dist_halo_plan_big_at_world_size_1_on_card(nccl_mesh, case, monkeypatch):
    """The halo, plan / exec / revalue and big-path entry points on the
    card: A×A's structure equal to scipy's, values within 1e-4 (counts exact
    in pattern mode); ``all_to_all_single`` runs in the halo exchange and
    the ``b_sharded`` plan, never in an exec; an all-ones plan revalued with
    normal values gives their product (F1)."""
    import torch.distributed as dist

    from spmm_tpu_torch import parallel
    from spmm_tpu_torch.ops import slab_spgemm as ss
    from spmm_tpu_torch.parallel.spgemm_spmd import partition_halo

    calls, esc_b = [], []
    real = dist.all_to_all_single
    monkeypatch.setattr(dist, "all_to_all_single", lambda *a, **k: calls.append(1) or real(*a, **k))
    real_esc = ss.spgemm_sorted
    monkeypatch.setattr(ss, "spgemm_sorted",
                        lambda M, B, *a, **k: esc_b.append((B.indices.is_cuda, B.nnz)) or real_esc(M, B, *a, **k))
    A, kw = _dist_case(case)
    ref = (A.to_scipy() @ A.to_scipy()).tocsr()
    ref.sort_indices()
    S = parallel.partition_rows(A, 1)
    halo_nnz = int(partition_halo(S, A, structure_only=True)[1][0, -1])
    _exact(parallel.spgemm_dist_halo(S, A, nccl_mesh, **kw), ref)
    assert calls == []
    _exact(parallel.spgemm_dist_halo_exchange(S, A, nccl_mesh, **kw), ref)
    assert len(calls) == (1 if case == "pattern" else 2)
    # the tail rows' ESC multiplies the halo on the card, not a copy of B
    assert esc_b == ([(True, halo_nnz)] * 2 if case == "tail" else [])
    for bs in (False, True):
        del calls[:]
        plan = parallel.spgemm_dist_plan(S, A, nccl_mesh, b_sharded=bs, **kw)
        assert len(calls) == (0 if not bs else 1 if case == "pattern" else 2)
        assert all(x.is_cuda for x in plan.aligned_cols + plan.aligned_vals)
        for _ in range(2):
            _exact(parallel.spgemm_dist_exec(plan, nccl_mesh), ref)
        assert len(calls) == (0 if not bs else 1 if case == "pattern" else 2)
        A2 = dataclasses.replace(A, data=np.random.default_rng(5).standard_normal(A.data.shape).astype(np.float32))
        ref2 = (A2.to_scipy() @ A2.to_scipy()).tocsr()
        ref2.sort_indices()
        plan2 = parallel.spgemm_dist_revalue(plan, parallel.partition_rows(A2, 1), A2, nccl_mesh)
        assert plan.pattern == (case == "pattern") and not plan2.pattern
        _exact(parallel.spgemm_dist_exec(plan2, nccl_mesh), ref2)
        _exact(parallel.spgemm_dist_big(A, A, nccl_mesh, pieces=2, b_sharded=bs, **kw), ref)


@pytest.mark.cuda
def test_dryrun_multichip_at_world_size_1_on_card(nccl_mesh, monkeypatch, capsys):
    """``dryrun_multichip(1)`` on the card prints its ten lines; with the
    pack threshold at 0 its two ring products and the column-split product
    launch K2."""
    from spmm_tpu_torch.entry import dryrun_multichip

    monkeypatch.setattr(importlib.import_module("spmm_tpu_torch.ops.spmm"), "AUTO_ELL_THRESHOLD", 0)
    n0 = ell_kernel.launches
    dryrun_multichip(1)
    assert ell_kernel.launches - n0 >= 3
    lines = capsys.readouterr().out.splitlines()
    assert len([ln for ln in lines if ln.startswith("dryrun") and " OK" in ln]) == 10


@pytest.mark.cuda
def test_primitive_rates_probe_on_card(cuda):
    """The rates probe at 2^20 elements on the card: every field of
    ``MeasuredRates``, each a positive finite rate, and K2 and the ordered
    sum launched by its gather and scatter measurements; the power-limit
    line names the card measured."""
    import math

    from spmm_tpu_torch.ops import segments
    from spmm_tpu_torch.ops.roofline import MeasuredRates
    from spmm_tpu_torch.utils.primitives import measure_rates, power_limit

    # nvidia-smi's line is that of the card measured
    assert power_limit(cuda).startswith(torch.cuda.get_device_name(cuda) + ", ")
    n0, n2 = segments.launches, ell_kernel.launches
    r = measure_rates(size_log2=20, device=cuda, log=lambda line: None)
    assert segments.launches > n0 and ell_kernel.launches > n2
    assert set(r) == {f.name for f in dataclasses.fields(MeasuredRates)}
    for k, v in r.items():
        vals = [x for pt in v for x in pt] if isinstance(v, tuple) else [v]
        assert vals and all(math.isfinite(x) and x > 0 for x in vals), k
    MeasuredRates(**r)


# ---- K4 and K5: the slab SpGEMM's numeric phase ------------------------------

_INT_MAX = 2**31 - 1

#: (L, W): every default class at W = 8 and the kernels' widest row, then
#: narrow and wide classes at W = 1 and 4
K4_CASES = ([(L, 8) for L in sorted({-(-c // 8) * 8 for c in (4, 8, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96, 128,
                                                              160, 192, 256, 320, 384, 512, 640, 768, 1024, 1280,
                                                              1536, 2048, 2560, 3072, 4096, 5120, 6144, 8192)})]
            + [(16384, 8)] + [(L, W) for W in (1, 4) for L in (4, 12, 40, 320, 5120, 16384)])
K4_MODES = {"pattern": (None, torch.float32), "fp32": (torch.float32, torch.float32),
            "fp64": (torch.float64, torch.float64), "bf16 B into fp32": (torch.bfloat16, torch.float32)}


def _k4_tables(cuda, L, W, values, seed, a_values=None):
    """A product's tables (``slab_spgemm._Tables``) made to hold every kind
    of row, and one chunk of them: (tables, start, count, R_pad).  Columns
    come from a range of L / 3, so rows hold runs of duplicates; a quarter of
    the segments end in pads, segment 0 is one column repeated and the last
    segment is all pads.  Chunk row 0 has no pa, row 1 reads segment 0 only
    (one repeated column), row 2 reads past npa (all pads); the last three
    rows are dead (count < R_pad).  ``a_values``: A's dtype when it is not
    B's (``values``)."""
    from spmm_tpu_torch.ops import slab_spgemm as ss

    rng = np.random.default_rng(seed)
    nblk = L // W
    R_pad = max(8, min(1024, (1 << 16) // L))
    nseg = 4 * nblk + 64
    cols = rng.integers(0, max(4, L // 3), (nseg, W)).astype(np.int32)
    for s in np.nonzero(rng.random(nseg) < 0.25)[0]:
        cols[s, rng.integers(1, W + 1):] = _INT_MAX
    cols[0] = 7
    cols[-1] = _INT_MAX
    npa = 3 * nblk + 50
    npa_pad = -(-(npa + nblk + 1) // 1024) * 1024
    pa_b2row = rng.integers(1, nseg - 1, npa_pad).astype(np.int32)
    pa_b2row[npa:] = nseg - 1
    pa_b2row[:nblk] = 0
    start = 5
    meta = np.stack([rng.integers(0, npa - nblk + 1, start + R_pad + 3),
                     rng.integers(0, nblk + 1, start + R_pad + 3)], axis=1).astype(np.int32)
    meta[start] = (0, 0)
    meta[start + 1] = (0, nblk)
    meta[start + 2] = (npa, nblk)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    if values is None:
        b2_vals, pa_aval = up(np.zeros((0, W), np.float32)), up(np.zeros(0, np.float32))
    else:
        scale = 1 if values.is_floating_point else 3  # integer tables hold small integers
        b2_vals = up(scale * rng.standard_normal((nseg, W))).to(values)
        pa_aval = up(scale * rng.standard_normal(npa_pad)).to(a_values or values)
    t = ss._Tables(up(cols), b2_vals, up(pa_b2row), pa_aval, up(meta), up(np.arange(len(meta), dtype=np.int32)))
    return t, start, R_pad - 3, R_pad


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(K4_MODES))
@pytest.mark.parametrize("L,W", K4_CASES)
def test_k4_k5_match_plain(cuda, L, W, mode):
    """K4 (a) bit-equal to ``_chunk_fetch``; (b) and (c) equal to
    ``_merge_block`` in columns and nuniq on the live slots, values within
    1e-5 of max |ref| of the float64 merge and 2e-5 of the plain version in
    fp32 (1e-12 in fp64; pattern counts exact), ``_INT_MAX`` / 0 past nuniq;
    (b) twice and (c) on the slab (a) built bit-identical; K5 equal to
    ``_compact_to_csr`` on (b)'s output, also when nnz_pad cuts it; one
    launch per call."""
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss

    values, acc = K4_MODES[mode]
    pattern = values is None
    t, start, count, R_pad = _k4_tables(cuda, L, W, values, seed=L + W)
    kw = dict(L=L, R_pad=R_pad, W=W, accum_dtype=acc, pattern=pattern)
    base, bm = ss._chunk_meta(t.rowmeta, start, count, R_pad, L // W)
    col_p, val_p = ss._chunk_fetch(t, base, bm, **kw)
    e0 = dict(sk.slab_launches)
    col, val = sk.chunk_fetch(t, start, count, **kw)
    b1 = sk.chunk_merge(t, start, count, **kw)
    b2 = sk.chunk_merge(t, start, count, **kw)
    c = sk.slab_merge(col, val, accum_dtype=acc, pattern=pattern)
    torch.cuda.synchronize()
    assert {k: v - e0[k] for k, v in sk.slab_launches.items()} == {"fetch": 1, "fetch_merge": 2, "merge": 1}
    assert torch.equal(col, col_p) and (pattern or torch.equal(val, val_p))
    for x, y, z in zip(b1, b2, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    cols_u, vals_u, nuniq = b1
    ref = ss._merge_block(col_p, val_p, accum_dtype=acc, pattern=pattern)
    assert torch.equal(nuniq, ref[2])
    assert int(nuniq[0]) == int(nuniq[2]) == 0 and int(nuniq[1]) == 1 and not nuniq[count:].any()
    live = torch.arange(L, device=cuda)[None, :] < nuniq[:, None]
    assert torch.equal(cols_u[live], ref[0][live])
    assert bool((cols_u[~live] == _INT_MAX).all()) and not vals_u[~live].any()
    if pattern:
        assert torch.equal(vals_u[live], ref[1][live])
        assert float(vals_u[1, 0]) == (L // W) * W  # one column repeated through the row
    else:
        exact = ss._merge_block(col_p, val_p.double(), accum_dtype=torch.float64, pattern=False)[1][live]
        scale = float(exact.abs().max())
        tol = 1e-12 if acc == torch.float64 else 1e-5
        assert float((vals_u[live].double() - exact).abs().max()) <= tol * scale
        assert float((vals_u[live] - ref[1][live]).abs().max()) <= (1e-12 if acc == torch.float64 else 2e-5) * scale
    # K5 on (b)'s output: the dead rows repeat live rows' ids with nuniq 0
    rows = torch.randperm(R_pad, generator=torch.Generator().manual_seed(L)).to(cuda, torch.int32)
    rows[count:] = rows[:3]
    outs = [(rows, cols_u, vals_u, nuniq)]
    total = int(nuniq.sum())
    for nnz_pad in (total, total // 2):
        m0 = sk.compact_launches
        got = sk.compact_to_csr(outs, nrow=R_pad, nnz_pad=nnz_pad, dtype=acc, device=cuda)
        want = ss._compact_to_csr(outs, nrow=R_pad, nnz_pad=nnz_pad, dtype=acc, device=cuda)
        assert sk.compact_launches == m0 + 1
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [24, 2048])
@pytest.mark.parametrize("b_dtype,a_dtype,acc", [
    (torch.float16, torch.float16, torch.float32), (torch.int64, torch.int32, torch.float64),
    (torch.float32, torch.float64, torch.float32), (torch.float64, torch.bfloat16, torch.float64)])
def test_k4_widens_every_table_dtype(cuda, L, b_dtype, a_dtype, acc):
    """K4 reads the value tables in any dtype the entry points take, widened
    to the accumulate type as torch's ``.to`` rounds them: (a) bit-equal to
    ``_chunk_fetch``, (b) and (c) bit-identical and within the tolerance of
    ``_merge_block``; a chunk with no live row (count 0) gives nuniq 0."""
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss

    W = 8
    t, start, count, R_pad = _k4_tables(cuda, L, W, b_dtype, seed=L, a_values=a_dtype)
    for cnt in (count, 0):
        kw = dict(L=L, R_pad=R_pad, W=W, accum_dtype=acc, pattern=False)
        col_p, val_p = ss._chunk_fetch(t, *ss._chunk_meta(t.rowmeta, start, cnt, R_pad, L // W), **kw)
        col, val = sk.chunk_fetch(t, start, cnt, **kw)
        b, c = sk.chunk_merge(t, start, cnt, **kw), sk.slab_merge(col, val, accum_dtype=acc, pattern=False)
        ref = ss._merge_block(col_p, val_p, accum_dtype=acc, pattern=False)
        torch.cuda.synchronize()
        assert torch.equal(col, col_p) and torch.equal(val, val_p)
        assert all(torch.equal(x, y) for x, y in zip(b, c)) and torch.equal(b[2], ref[2])
        live = torch.arange(L, device=cuda)[None, :] < ref[2][:, None]
        assert torch.equal(b[0][live], ref[0][live])
        if cnt:
            tol = 1e-12 if acc == torch.float64 else 2e-5
            assert float((b[1][live] - ref[1][live]).abs().max()) <= tol * float(ref[1][live].abs().max())
        else:
            assert not b[2].any()  # every row dead


@pytest.mark.cuda
def test_slab_entry_points_run_only_the_kernels_on_card(cuda, monkeypatch):
    """Every slab SpGEMM entry point on the card runs S1, S2 and S3 through
    K4 and K5 only: with the plain versions made to fail, each product is
    still exact against scipy, and the launch counters moved."""
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss

    def plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("_chunk_fetch", "_merge_block", "_compact_to_csr", "_chunk_meta"):
        monkeypatch.setattr(sk, name, plain)
    monkeypatch.setattr(ss, "AUTO_PLAN_MIN_NNZ", 1)
    A = tsyn.webgraph_like(4000, 24000, seed=3)
    S = A.to_scipy()
    ref = (S @ S).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()

    def exact(C):
        np.testing.assert_array_equal(np.asarray(C.indptr, np.int64), ref.indptr)
        np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
        np.testing.assert_array_equal(np.asarray(C.data[: C.nnz]), ref.data)

    m0, e0 = sk.compact_launches, dict(sk.slab_launches)
    ss._PLAN_SEEN.clear()
    ss._PLAN_CACHE.clear()
    for _ in range(3):  # cold, plan build, plan reuse
        exact(ops.spgemm(A, A, device=cuda))
    plan = ss.spgemm_plan(A, A, device=cuda)
    for outs in (ss.spgemm_slab_device(A, A, plan)[0], ss.spgemm_chain_device(plan, 2),
                 ss.spgemm_slab_device(A, A, device=cuda)[0]):
        exact(ss._csr_to_host(ss._csr_of(outs, A.shape, ss._round_up(plan.npa * 8, 1024), torch.float32, cuda)))
    exact(ss._csr_to_host(ss.spgemm_slab_csr(A, A, device=cuda)))
    exact(ss.spgemm_slab_big(A, A, pieces=2, device=cuda))
    moved = {k: v - e0[k] for k, v in sk.slab_launches.items()}
    assert all(n > 0 for n in moved.values()) and sk.compact_launches > m0, moved
    ss._PLAN_SEEN.clear()
    ss._PLAN_CACHE.clear()


@pytest.mark.cuda
def test_class_above_the_kernel_limit_raises_on_card(cuda):
    """A class wider than ``slab_kernel.MAX_L`` raises up front on CUDA
    operands, naming the limit (no torch fallback)."""
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss

    A = tsyn.webgraph_like(500, 3000, seed=1)
    wide = (8, 64, 2 * sk.MAX_L)
    for call in (lambda: ops.spgemm(A, A, classes=wide, device=cuda),
                 lambda: ss.spgemm_plan(A, A, classes=wide, device=cuda),
                 lambda: ss.spgemm_slab_big(A, A, pieces=2, classes=wide, device=cuda)):
        with pytest.raises(ValueError, match=str(sk.MAX_L)):
            call()


# ---- K4's natural-run merge and K5, per product -------------------------------


def _reversed_rows(M):
    """M with each row's columns in descending order (rows that do not
    ascend: every B row becomes runs of one slot)."""
    ind = M.indices.copy()
    for r in range(M.nrow):
        ind[M.indptr[r] : M.indptr[r + 1]] = ind[M.indptr[r] : M.indptr[r + 1]][::-1]
    return dataclasses.replace(M, indices=ind)


def _repeated_column(M):
    """M with each row of two or more entries repeating its first column in
    its second slot (a column twice in a B row)."""
    ind = M.indices.copy()
    rows = np.nonzero(np.diff(M.indptr) >= 2)[0]
    ind[M.indptr[rows] + 1] = ind[M.indptr[rows]]
    return dataclasses.replace(M, indices=ind)


def _scipy_product(A, B):
    C = (A.to_scipy() @ B.to_scipy()).tocsr()
    C.sum_duplicates()
    C.sort_indices()
    return C


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", [False, True])
def test_k4_k5_one_launch_per_product_per_group(cuda, pattern):
    """A product whose chunks fall in both block-size groups: K4 (b) and (c)
    take one launch per group (``merge_plan``), K5 one count and one copy
    pass per product, and the product's chunk outputs equal, bit for bit,
    each chunk merged alone."""
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss

    A = tsyn.webgraph_like(6000, 36000, seed=4)
    if not pattern:
        A = dataclasses.replace(A, data=rhs(1, A.nnz_pad, 8)[0])
    classes = (8, 64, 8192)
    plan = ss.spgemm_plan(A, A, classes=classes, device=cuda, pattern=pattern)
    sched, _ = ss._chunk_schedule(plan.classes, plan.class_counts, plan.slot_budget)
    groups = {sk.merge_group(L) for L, _, _, _ in sched}
    assert len(groups) >= 2
    e0, m0 = dict(sk.slab_launches), sk.compact_launches
    b = sk.chunk_merge_all(plan, sched, W=plan.seg_w, accum_dtype=torch.float32, pattern=pattern)
    c = sk.slab_merge_all(plan.aligned_cols, plan.aligned_vals, accum_dtype=torch.float32, pattern=pattern)
    outs = [(plan.rows_sorted[st : st + R],) + x for (_, R, st, _), x in zip(sched, c)]
    C = sk.compact_to_csr(outs, nrow=A.nrow, nnz_pad=ss._round_up(plan.npa * plan.seg_w, 1024),
                          dtype=torch.float32, device=cuda)
    torch.cuda.synchronize()
    moved = {k: v - e0[k] for k, v in sk.slab_launches.items()}
    assert moved == {"fetch": 0, "fetch_merge": len(groups), "merge": len(groups)}
    assert sk.compact_launches == m0 + 1
    for i, (L, R, st, cnt) in enumerate(sched):
        one = sk.chunk_merge(plan, st, cnt, L=L, R_pad=R, W=plan.seg_w, accum_dtype=torch.float32, pattern=pattern)
        for x, y, z in zip(b[i], c[i], one):
            assert torch.equal(x, y) and torch.equal(x, z)
    ref = _scipy_product(A, A)
    np.testing.assert_array_equal(C[2].cpu().numpy(), ref.indptr)
    np.testing.assert_array_equal(C[1][: ref.nnz].cpu().numpy(), ref.indices)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pattern", "fp32", "fp64"])
@pytest.mark.parametrize("kind", ["descending", "repeated column"])
def test_k4_on_unsorted_b_matches_plain(cuda, kind, mode):
    """B rows that descend or repeat a column only give more and shorter
    runs: (b) and (c) equal ``_merge_block`` on every chunk (columns and
    nuniq exact, values within the tolerance), bit-identical to each other,
    and the product exact against scipy's (which sums the repeats)."""
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss

    acc = torch.float64 if mode == "fp64" else torch.float32
    A = tsyn.webgraph_like(4000, 24000, seed=9)
    if mode != "pattern":
        A = dataclasses.replace(A, data=rhs(1, A.nnz_pad, 9)[0].astype(np.float64 if mode == "fp64" else np.float32))
    B = _reversed_rows(A) if kind == "descending" else _repeated_column(A)
    plan = ss.spgemm_plan(A, B, device=cuda, accum_dtype=acc, pattern=mode == "pattern")
    sched, _ = ss._chunk_schedule(plan.classes, plan.class_counts, plan.slot_budget)
    b = sk.chunk_merge_all(plan, sched, W=plan.seg_w, accum_dtype=acc, pattern=plan.pattern)
    vals = list(plan.aligned_vals) or [None] * len(sched)
    c = sk.slab_merge_all(plan.aligned_cols, vals, accum_dtype=acc, pattern=plan.pattern)
    tol = 1e-12 if acc == torch.float64 else 2e-5
    for i, col in enumerate(plan.aligned_cols):
        ref = ss._merge_block(col, vals[i], accum_dtype=acc, pattern=plan.pattern)
        assert all(torch.equal(x, y) for x, y in zip(b[i], c[i]))
        assert torch.equal(c[i][2], ref[2])
        live = torch.arange(col.shape[1], device=cuda)[None, :] < ref[2][:, None]
        assert torch.equal(c[i][0][live], ref[0][live])
        err = float((c[i][1][live] - ref[1][live]).abs().max()) if live.any() else 0.0
        assert err <= tol * max(float(ref[1][live].abs().max()) if live.any() else 0.0, 1e-30)
    C = ss._csr_to_host(ss.spgemm_slab_csr(A, B, device=cuda, accum_dtype=acc, pattern=plan.pattern))
    ref = _scipy_product(A, B)
    np.testing.assert_array_equal(np.asarray(C.indptr, np.int64), ref.indptr)
    np.testing.assert_array_equal(np.asarray(C.indices), ref.indices)
    np.testing.assert_allclose(np.asarray(C.data), ref.data, rtol=1e-4, atol=1e-4 * float(np.abs(ref.data).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["as fetched", "each row reversed"])
def test_k4_widest_class_fp64(cuda, order):
    """The 16,384-slot class in fp64 (229,376 B of shared memory, the wide
    block size), rows as fetched and each row reversed (one-slot runs):
    (c) equal to ``_merge_block``, ``_INT_MAX`` / 0 past nuniq."""
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss

    L = sk.MAX_L
    t, start, count, R_pad = _k4_tables(cuda, L, 8, torch.float64, seed=17)
    kw = dict(L=L, R_pad=R_pad, W=8, accum_dtype=torch.float64, pattern=False)
    col, val = sk.chunk_fetch(t, start, count, **kw)
    if order == "each row reversed":
        col, val = col.flip(1).contiguous(), val.flip(1).contiguous()
    got = sk.slab_merge(col, val, accum_dtype=torch.float64, pattern=False)
    ref = ss._merge_block(col, val, accum_dtype=torch.float64, pattern=False)
    torch.cuda.synchronize()
    assert torch.equal(got[2], ref[2])
    live = torch.arange(L, device=cuda)[None, :] < ref[2][:, None]
    assert torch.equal(got[0][live], ref[0][live])
    assert float((got[1][live] - ref[1][live]).abs().max()) <= 1e-12 * float(ref[1][live].abs().max())
    assert bool((got[0][~live] == _INT_MAX).all()) and not got[1][~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("room", ["padding past nnz", "nnz_pad cuts the product"])
def test_k5_zeros_past_nnz_and_cut(cuda, room):
    """K5 writes every slot of data and indices: zeros in [nnz, nnz_pad)
    even where the allocator hands back memory that held other values, and
    entries at or past nnz_pad dropped; equal to ``_compact_to_csr``."""
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss

    A = tsyn.webgraph_like(5000, 30000, seed=12)
    A = dataclasses.replace(A, data=rhs(1, A.nnz_pad, 12)[0])
    outs, _, _ = ss.spgemm_slab_device(A, A, ss.spgemm_plan(A, A, device=cuda))
    nnz = int(sum(int(o[3].sum()) for o in outs))
    nnz_pad = nnz + 4099 if room == "padding past nnz" else nnz // 2 + 3
    junk = torch.full((4 * nnz_pad,), 7.0, device=cuda)  # the allocator's blocks now hold sevens
    del junk
    got = sk.compact_to_csr(outs, nrow=A.nrow, nnz_pad=nnz_pad, dtype=torch.float32, device=cuda)
    want = sk._compact_to_csr(outs, nrow=A.nrow, nnz_pad=nnz_pad, dtype=torch.float32, device=cuda)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert int(got[3]) == nnz
    if nnz_pad > nnz:
        assert not got[0][nnz:].any() and not got[1][nnz:].any()


@pytest.mark.cuda
def test_no_plain_version_on_card(nccl_mesh, monkeypatch):
    """With ``_merge_block``, ``_row_offsets`` (the plain route's
    ``scatter_reduce_`` row counts), ``_compact_to_csr``, ``_chunk_fetch`` and
    ``_chunk_meta`` made to raise, every entry point that reaches K4 and K5 --
    ``ops.spgemm`` cold, with its plan and reusing it, the chain, the big
    path and ``spgemm_dist_exec`` at world size 1 -- is exact against scipy:
    no CUDA operand reaches a plain version."""
    from spmm_tpu_torch import parallel
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss

    def plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("_merge_block", "_row_offsets", "_compact_to_csr", "_chunk_fetch", "_chunk_meta"):
        monkeypatch.setattr(sk, name, plain)
    monkeypatch.setattr(ss, "AUTO_PLAN_MIN_NNZ", 1)
    A = tsyn.webgraph_like(4000, 24000, seed=13)
    ref = _scipy_product(A, A)
    ss._PLAN_SEEN.clear()
    ss._PLAN_CACHE.clear()
    for _ in range(3):  # cold, plan build, plan reuse
        _exact(ops.spgemm(A, A, device=torch.device("cuda")), ref)
    plan = ss.spgemm_plan(A, A, device=torch.device("cuda"))
    _exact(ss._csr_to_host(ss._csr_of(ss.spgemm_chain_device(plan, 3), A.shape, ss._round_up(plan.npa * 8, 1024),
                                      torch.float32, torch.device("cuda"))), ref)
    _exact(ss.spgemm_slab_big(A, A, pieces=3, device=torch.device("cuda")), ref)
    dplan = parallel.spgemm_dist_plan(parallel.partition_rows(A, 1), A, nccl_mesh)
    _exact(parallel.spgemm_dist_exec(dplan, nccl_mesh), ref)
    ss._PLAN_SEEN.clear()
    ss._PLAN_CACHE.clear()


# ---- K4 (a): the aligned cache's fetch, one launch per plan ------------------

#: (W, L, unaligned tables): the piece kernel at W 8 and 4, the slot kernel at
#: W 3 and on tables that start 4 bytes (one element) past a 16-byte boundary
K4A_LAYOUTS = {"W 8": (8, 40, False), "W 4": (4, 12, False), "W 3": (3, 12, False),
               "unaligned tables": (8, 40, True)}
#: every dtype the value tables may hold (None: pattern mode)
K4A_VALUES = {"pattern": None, "fp32": torch.float32, "fp64": torch.float64, "bf16": torch.bfloat16,
              "fp16": torch.float16, "int32": torch.int32, "int64": torch.int64}


def _off16(x):
    """``x`` at an address one element past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("acc", [torch.float32, torch.float64], ids=["fp32 acc", "fp64 acc"])
@pytest.mark.parametrize("values", sorted(K4A_VALUES))
@pytest.mark.parametrize("layout", sorted(K4A_LAYOUTS))
def test_k4a_fetch_all_matches_plain(cuda, layout, values, acc):
    """``chunk_fetch_all`` over a schedule of a full chunk, an empty one,
    a one-row one, a wider class and a chunk with rows past its count: one
    launch, every chunk ``torch.equal`` to ``_chunk_fetch`` (columns, values
    and the zeros at pads) for every table dtype and both accumulate types,
    on the piece kernel and the slot kernel; each view 16-byte aligned."""
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss

    W, L, unaligned = K4A_LAYOUTS[layout]
    dt = K4A_VALUES[values]
    pattern = dt is None
    t, start, count, R_pad = _k4_tables(cuda, L, W, dt, seed=L + W, a_values=torch.float32 if dt == torch.int64
                                        else None)
    if unaligned:
        t = t._replace(b2_cols=_off16(t.b2_cols), b2_vals=t.b2_vals if pattern else _off16(t.b2_vals))
        assert t.b2_cols.data_ptr() % 16
    sched = [(L, R_pad, start, count), (L, 0, start, 0), (L + W, 1, start + 1, 1), (2 * W, 5, start, 3)]
    e0 = sk.slab_launches["fetch"]
    got = sk.chunk_fetch_all(t, sched, W=W, accum_dtype=acc, pattern=pattern)
    torch.cuda.synchronize()
    assert sk.slab_launches["fetch"] == e0 + 1
    for (Lc, R, st, cnt), (col, val) in zip(sched, got):
        kw = dict(L=Lc, R_pad=R, W=W, accum_dtype=acc, pattern=pattern)
        col_p, val_p = ss._chunk_fetch(t, *ss._chunk_meta(t.rowmeta, st, cnt, R, Lc // W), **kw)
        assert col.shape == (R, Lc) and col.is_contiguous() and col.data_ptr() % 16 == 0
        assert torch.equal(col, col_p)
        if pattern:
            assert val is None
        else:
            assert val.dtype == acc and val.data_ptr() % 16 == 0 and torch.equal(val, val_p)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", [False, True])
def test_k4a_one_launch_per_plan(cuda, pattern):
    """``spgemm_plan`` and ``spgemm_plan_revalue`` take one K4 (a) launch per
    plan, or one per ``MAX_LAUNCH_CHUNKS`` chunks of a longer schedule; the
    revalued plan's cache is bit-equal to a fresh plan's on the new values,
    and its products are exact against scipy."""
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss

    A = tsyn.webgraph_like(6000, 36000, seed=4)
    if not pattern:
        A = dataclasses.replace(A, data=rhs(1, A.nnz_pad, 4)[0])
    for budget in (ss.DEFAULT_SLOT_BUDGET, 1 << 12):
        sched, _ = ss._chunk_schedule(ss._norm_classes(ss.DEFAULT_CLASSES, 8),
                                      ss._sizing(A, A, 8, ss._norm_classes(ss.DEFAULT_CLASSES, 8)).counts, budget)
        want = -(-len(sched) // sk.MAX_LAUNCH_CHUNKS)
        e0 = sk.slab_launches["fetch"]
        plan = ss.spgemm_plan(A, A, device=cuda, slot_budget=budget, pattern=pattern)
        assert sk.slab_launches["fetch"] == e0 + want
        A2 = dataclasses.replace(A, data=rhs(1, A.nnz_pad, 5)[0]) if not pattern else A
        e0 = sk.slab_launches["fetch"]
        again = ss.spgemm_plan_revalue(plan, A2, A2, pattern=pattern)
        assert sk.slab_launches["fetch"] == e0 + want
        fresh = ss.spgemm_plan(A2, A2, device=cuda, slot_budget=budget, pattern=pattern)
        assert len(again.aligned_cols) == len(fresh.aligned_cols) == len(sched)
        for x, y in zip(again.aligned_cols + again.aligned_vals, fresh.aligned_cols + fresh.aligned_vals):
            assert torch.equal(x, y)
        outs, _, _ = ss.spgemm_slab_device(A2, A2, again)
        _exact(ss._csr_to_host(ss._csr_of(outs, A.shape, ss._round_up(again.npa * 8, 1024), torch.float32, cuda)),
               _scipy_product(A2, A2))
    assert want > 1  # the small budget's schedule splits


@pytest.mark.cuda
def test_k4a_one_launch_per_shard(nccl_mesh):
    """``spgemm_dist_plan`` and ``spgemm_dist_revalue`` at world size 1 build
    the shard's cache by one K4 (a) launch each, and the plan's product is
    exact against scipy."""
    from spmm_tpu_torch import parallel
    from spmm_tpu_torch.ops import slab_kernel as sk

    A = tsyn.webgraph_like(4000, 24000, seed=13)
    S = parallel.partition_rows(A, 1)
    e0 = sk.slab_launches["fetch"]
    dplan = parallel.spgemm_dist_plan(S, A, nccl_mesh)
    assert sk.slab_launches["fetch"] == e0 + 1
    _exact(parallel.spgemm_dist_exec(dplan, nccl_mesh), _scipy_product(A, A))
    e0 = sk.slab_launches["fetch"]
    parallel.spgemm_dist_revalue(dplan, S, A, nccl_mesh)
    assert sk.slab_launches["fetch"] == e0 + 1


@pytest.mark.cuda
def test_k4a_raises_on_a_cpu_table_and_never_falls_back(cuda, monkeypatch):
    """With the chunk's rows on the card and one table left on the CPU, the
    fetch raises naming the tables, launches nothing and never reaches the
    plain version."""
    from spmm_tpu_torch.ops import slab_kernel as sk

    def plain(*a, **k):
        raise AssertionError("a plain version ran")

    t, start, count, R_pad = _k4_tables(cuda, 40, 8, torch.float32, seed=1)
    monkeypatch.setattr(sk, "_chunk_fetch", plain)
    monkeypatch.setattr(sk, "_chunk_meta", plain)
    e0 = sk.slab_launches["fetch"]
    for name in ("b2_cols", "b2_vals", "pa_b2row", "pa_aval"):
        bad = t._replace(**{name: getattr(t, name).cpu()})
        with pytest.raises(ValueError, match="contiguous tensors on cuda"):
            sk.chunk_fetch_all(bad, [(40, R_pad, start, count)], W=8, accum_dtype=torch.float32, pattern=False)
    assert sk.slab_launches["fetch"] == e0
