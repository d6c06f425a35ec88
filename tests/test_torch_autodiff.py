"""Gradients through the port's SpMM / SpMV / SDDMM against ``jax.grad`` of the
JAX package and the analytic scipy values.

Mirrors ``tests/test_autodiff.py`` case by case (its five, the batched one as
a (b, n, k) stack), at that file's sizes, seeds and tolerances (1e-4; 2e-3
for the slab consumer), with the same numpy-seeded inputs and the same
containers (carried across by ``formats.convert.from_numpy``) through both
packages.  On the CPU the kernel wrappers run their plain versions, which
autograd differentiates as they stand; the backward kernels (K2 on the
transposed pack, K3, K1 on the transposed BSR) are held against the plain
versions on the card by ``tests/test_torch_cuda.py``, and here their plain
versions and their packs are held against dense numpy and scipy's ``.T``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmm_tpu.config import Config as JConfig
from spmm_tpu.formats import bsr as jbsr
from spmm_tpu.formats import ell as jell
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.ops import spmm_xla as j_spmm_xla
from spmm_tpu.ops.blocked import blocked_slab_view as j_slab_view
from spmm_tpu.ops.blocked import blocked_spmm_slab as j_blocked_spmm_slab
from spmm_tpu.ops.ell_spmm import ell_spmm as j_ell_spmm
from spmm_tpu.ops.pallas_bsr import bsr_spmm_xla as j_bsr_spmm_xla
from spmm_tpu.ops.pallas_bsr import bsr_spmv as j_bsr_spmv
from spmm_tpu.ops.sddmm import sddmm_values as j_sddmm_values
from spmm_tpu.preprocess import preprocess as j_preprocess

from spmm_tpu_torch import ops
from spmm_tpu_torch.formats.convert import from_numpy
from spmm_tpu_torch.ops import bsr_kernel

from torch_parity import rhs, one_torch_thread  # noqa: F401  (autouse)


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _loss_grad(fn, B0):
    """d/dB sum(fn(B)^2) by torch autograd, as numpy."""
    B = torch.from_numpy(B0).requires_grad_()
    (fn(B) ** 2).sum().backward()
    return B.grad.numpy()


def _analytic(S, B0):
    return 2.0 * (S.T @ (S @ B0))


# ---- the five cases of tests/test_autodiff.py -----------------------------------


def test_spmm_grad_wrt_dense():
    A = jsyn.webgraph_like(200, 1200, seed=0)
    Ad = A.pad(8).device()
    B0 = rhs(200, 4, 0)
    gj = jax.grad(lambda B: jnp.sum(j_spmm_xla(Ad, B) ** 2))(jnp.asarray(B0))
    At = from_numpy(A.pad(8))
    gt = _loss_grad(lambda B: ops.spmm_xla(At, B), B0)
    _close(gt, gj)
    _close(gt, _analytic(A.to_scipy(), B0))


def test_spmm_grad_wrt_values():
    """Gradients w.r.t. the sparse VALUES (e.g. learnable edge weights)."""
    A = jsyn.webgraph_like(150, 900, seed=1)
    Ad = A.pad(8).device()
    B0 = rhs(150, 4, 1)
    gj = jax.grad(lambda v: jnp.sum(j_spmm_xla(dataclasses.replace(Ad, data=v), jnp.asarray(B0)) ** 2))(
        jnp.asarray(Ad.data))
    At = from_numpy(A.pad(8))
    vals = torch.from_numpy(At.data).requires_grad_()
    (ops.spmm_xla(dataclasses.replace(At, data=vals), torch.from_numpy(B0)) ** 2).sum().backward()
    _close(vals.grad.numpy(), gj)
    # d/dv_e ||Y||^2 = 2 Y[row_e] . B[col_e]
    S = A.to_scipy()
    Y = S @ B0
    rows = np.repeat(np.arange(150), np.diff(np.asarray(A.indptr)))
    cols = np.asarray(A.indices[: A.nnz])
    _close(vals.grad.numpy()[: A.nnz], 2.0 * np.einsum("ek,ek->e", Y[rows], B0[cols]))


def test_ell_spmm_grad():
    A = jsyn.webgraph_like(200, 1300, seed=2)
    Ej = jell.ell_pack(A)
    B0 = rhs(200, 8, 2)
    gj = jax.grad(lambda B: jnp.sum(j_ell_spmm(Ej.device(), B) ** 2))(jnp.asarray(B0))
    Et = from_numpy(Ej)
    gt = _loss_grad(lambda B: ops.ell_spmm(Et, B), B0)
    _close(gt, gj)
    _close(gt, _analytic(A.to_scipy(), B0))


def test_grad_through_blocked_slab_consumer():
    """Gradients w.r.t. the dense operand flow through the v8-slab consumer
    (K2's plain version per bucket + leftover stream + un-permute gather)."""
    A = jsyn.webgraph_like(1500, 9000, seed=23)
    Pj = j_preprocess(A, JConfig(region_budget=512, panel_rows=256))
    B0 = rhs(1500, 8, 6)
    Pd = Pj.device()
    vj = j_slab_view(Pd)
    gj = jax.grad(lambda B: jnp.sum(j_blocked_spmm_slab(Pd, B, vj) ** 2))(jnp.asarray(B0))
    Pt = from_numpy(Pj).to("cpu")
    vt = ops.blocked_slab_view(Pt)
    gt = _loss_grad(lambda B: ops.blocked_spmm_slab(Pt, B, vt), B0)
    _close(gt, gj, 2e-3)
    _close(gt, _analytic(A.to_scipy(), B0), 2e-3)


def test_batched_spmm():
    """One sparse A against a stack (b, n, k) of dense right-hand sides -- the
    batched form, what ``vmap`` over B is in the JAX package -- through
    ``spmm_xla`` and ``ell_spmm``, and per-batch gradients in one call."""
    A = jsyn.webgraph_like(200, 1200, seed=3)
    Ad = A.pad(8).device()
    Bb = np.random.default_rng(4).standard_normal((3, 200, 8)).astype(np.float32)
    S = A.to_scipy()
    ref = np.stack([S @ Bb[i] for i in range(3)])
    At = from_numpy(A.pad(8))
    Bt = torch.from_numpy(Bb)

    Yx = ops.spmm_xla(At, Bt)
    assert Yx.shape == (3, 200, 8)
    _close(Yx.numpy(), np.asarray(jax.vmap(lambda B: j_spmm_xla(Ad, B))(jnp.asarray(Bb))))
    _close(Yx.numpy(), ref)

    Ej = jell.ell_pack(A)
    Et = from_numpy(Ej)
    Ye = ops.ell_spmm(Et, Bt)
    assert Ye.shape == (3, 200, 8)
    _close(Ye.numpy(), np.asarray(jax.vmap(lambda B: j_ell_spmm(Ej.device(), B))(jnp.asarray(Bb))))
    _close(Ye.numpy(), ref)

    # per-batch gradients in one call: the loss is a sum over the stack
    gj = jax.vmap(jax.grad(lambda B: jnp.sum(j_spmm_xla(Ad, B) ** 2)))(jnp.asarray(Bb))
    gref = np.stack([_analytic(S, Bb[i]) for i in range(3)])
    for fn in (lambda B: ops.spmm_xla(At, B), lambda B: ops.ell_spmm(Et, B)):
        g = _loss_grad(fn, Bb)
        _close(g, gj)
        _close(g, gref)
    with pytest.raises(ValueError, match="stack"):
        ops.spmm_xla(At, torch.zeros(2, 2, 200, 8))


# ---- gradients the JAX tests do not pin: slab values, block values, SpMV, SDDMM --


def test_ell_spmm_grad_wrt_slab_values():
    A = jsyn.webgraph_like(200, 1300, seed=5)
    Ej = jell.ell_pack(A, max_len=64)  # some leftover rows too
    Ed = Ej.device()
    B0 = rhs(200, 8, 5)
    gj = jax.grad(lambda d: jnp.sum(j_ell_spmm(dataclasses.replace(Ed, data=d), jnp.asarray(B0)) ** 2))(
        tuple(Ed.data))
    Et = from_numpy(Ej).to("cpu")
    data = tuple(d.clone().requires_grad_() for d in Et.data)
    Y = ops.ell_spmm(dataclasses.replace(Et, data=data), torch.from_numpy(B0))
    gt = torch.autograd.grad((Y ** 2).sum(), data)
    assert len(gt) == len(gj) > 1
    Yh = A.to_scipy() @ B0
    perm = np.asarray(Ej.perm)
    row = Ej.n_empty
    for g, j, c in zip(gt, gj, Ej.cols):
        _close(g.numpy(), j)
        # every slot, padding included, gets 2 Y[row] . B[col]
        R = c.shape[0]
        _close(g.numpy(), 2.0 * np.einsum("rk,rlk->rl", Yh[perm[row : row + R]], B0[np.asarray(c)]))
        row += R


def test_bsr_spmm_grad_wrt_dense_and_blocks():
    A = jsyn.banded_random(300, 64, 0.4, seed=8)
    Aj = jbsr.csr_to_bsr(A)
    Ad = Aj.device()
    B0 = rhs(300, 128, 9)
    gB_j, gD_j = jax.grad(
        lambda B, d: jnp.sum(j_bsr_spmm_xla(dataclasses.replace(Ad, data=d), B) ** 2), argnums=(0, 1))(
        jnp.asarray(B0), jnp.asarray(Ad.data))
    At = from_numpy(Aj).to("cpu")
    B = torch.from_numpy(B0).requires_grad_()
    blocks = At.data.clone().requires_grad_()
    gB, gD = torch.autograd.grad((ops.bsr_spmm(dataclasses.replace(At, data=blocks), B) ** 2).sum(),
                                 [B, blocks])
    _close(gB.numpy(), gB_j, 1e-3)
    _close(gD.numpy(), gD_j, 1e-3)
    _close(gB.numpy(), _analytic(A.to_scipy(), B0), 1e-3)
    # the card's value gradient: dData[b] = dY[rows of b] . B[cols of b]^T
    with torch.no_grad():
        dY = 2.0 * ops.bsr_spmm(At, B)
        _close(ops.bsr_data_grad(At, dY, B).numpy(), gD_j, 1e-3)


def test_bsr_spmv_is_differentiable():
    A = jsyn.banded_random(300, 64, 0.4, seed=10)
    Aj = jbsr.csr_to_bsr(A)
    x0 = rhs(300, 1, 11)[:, 0]
    gj = jax.grad(lambda x: jnp.sum(j_bsr_spmv(Aj.device(), x) ** 2))(jnp.asarray(x0))
    At = from_numpy(Aj)
    gt = _loss_grad(lambda x: ops.bsr_spmv(At, x), x0)
    _close(gt, gj)
    S = A.to_scipy()
    _close(gt, 2.0 * (S.T @ (S @ x0)))


def test_sddmm_grad():
    A = jsyn.webgraph_like(120, 700, seed=12)
    Ad = A.pad(8).device()
    U0, V0 = rhs(120, 6, 13), rhs(120, 6, 14)
    live = jnp.arange(Ad.nnz_pad) < A.nnz
    gU_j, gV_j = jax.grad(
        lambda U, V: jnp.sum(jnp.where(live, j_sddmm_values(Ad, U, V), 0.0) ** 2), argnums=(0, 1))(
        jnp.asarray(U0), jnp.asarray(V0))
    At = from_numpy(A.pad(8))
    U = torch.from_numpy(U0).requires_grad_()
    V = torch.from_numpy(V0).requires_grad_()
    C = ops.sddmm(At, U, V)
    gU, gV = torch.autograd.grad((C.data ** 2).sum(), [U, V])
    _close(gU.numpy(), gU_j)
    _close(gV.numpy(), gV_j)
    # scaled by A's values, the gradient reaches them too
    vals = torch.from_numpy(At.data).requires_grad_()
    Cs = ops.sddmm(dataclasses.replace(At, data=vals), U, V, scale_by_values=True)
    (gv,) = torch.autograd.grad(Cs.data.sum(), [vals])
    rows = np.repeat(np.arange(120), np.diff(np.asarray(A.indptr)))
    _close(gv.numpy()[: A.nnz], np.einsum("ek,ek->e", U0[rows], V0[np.asarray(A.indices[: A.nnz])]))


@pytest.mark.parametrize("form", ["ell", "bsr", "blocked", "csr_large", "csr_small"])
def test_grad_through_the_dispatcher(form, monkeypatch):
    """``ops.spmm`` hands the gradient through for every format."""
    import importlib

    from spmm_tpu_torch.config import Config
    from spmm_tpu_torch.formats import csr_to_bsr, ell_pack
    from spmm_tpu_torch.formats import synthetic as tsyn
    from spmm_tpu_torch.preprocess import preprocess

    spmm_mod = importlib.import_module("spmm_tpu_torch.ops.spmm")
    if form == "bsr":
        A = tsyn.banded_random(256, 48, 0.4, seed=15)
        M = csr_to_bsr(A)
    else:
        A = tsyn.webgraph_like(600, 3600, seed=16)
        M = {"ell": lambda: ell_pack(A),
             "blocked": lambda: preprocess(A, Config(region_budget=256, panel_rows=128)),
             "csr_large": lambda: A, "csr_small": lambda: A}[form]()
        monkeypatch.setattr(spmm_mod, "AUTO_ELL_THRESHOLD", 1 if form == "csr_large" else 1 << 30)
    B0 = rhs(A.shape[1], 128, 17)
    _close(_loss_grad(lambda B: ops.spmm(M, B), B0), _analytic(A.to_scipy(), B0), 2e-3)


# ---- the backward kernels' plain versions and packs, against dense numpy --------


def _slabs(seed, n, shapes=((5, 3), (0, 4), (2, 70), (4, 1), (3, 9))):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-2, n + 2, size=s).astype(np.int32) for s in shapes]
    data = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return cols, data


def _dense_of(cols, data, n):
    rows = sum(c.shape[0] for c in cols)
    D = np.zeros((rows, n))
    r0 = 0
    for c, d in zip(cols, data):
        for r in range(c.shape[0]):
            np.add.at(D[r0 + r], np.clip(c[r], 0, n - 1), d[r])
        r0 += c.shape[0]
    return D


@pytest.mark.parametrize("k", [1, 5, 128])
def test_k3_plain_matches_dense(k):
    n = 40
    cols, data = _slabs(k, n)
    rows = sum(c.shape[0] for c in cols)
    dY, B = rhs(rows, k, 1), rhs(n, k, 2)
    out = ops.ell_slabs_sddmm([torch.from_numpy(c) for c in cols], torch.from_numpy(dY), torch.from_numpy(B))
    full = dY.astype(np.float64) @ B.astype(np.float64).T  # (rows, n)
    r0 = 0
    for o, c in zip(out, cols, strict=True):
        want = np.take_along_axis(full[r0 : r0 + c.shape[0]], np.clip(c, 0, n - 1).astype(np.int64), axis=1)
        _close(o.numpy(), want, 1e-5)
        r0 += c.shape[0]
    # and it is the gradient autograd takes of the plain K2
    dt = [torch.from_numpy(d).requires_grad_() for d in data]
    Y = ops.ell_slabs_spmm([torch.from_numpy(c) for c in cols], dt, torch.from_numpy(B))
    for g, o in zip(torch.autograd.grad(Y, dt, torch.from_numpy(dY)), out):
        _close(g.numpy(), o.numpy(), 1e-5)


@pytest.mark.parametrize("cut", [4, 16, 2048])
@pytest.mark.parametrize("k", [1, 8])
def test_transposed_pack_product_matches_dense(cut, k):
    """Aᵀ · dY over the transposed pack (rows cut into pieces of ``cut``
    entries, empty rows of Aᵀ) against the dense transpose."""
    n = 40
    cols, data = _slabs(cut + k, n, shapes=((5, 3), (0, 4), (2, 70), (4, 1), (30, 9)))
    cols[4][:, 0] = 7  # a hub: column 7 in every row of the last slab
    cols = [np.where(c == 11, 12, c) for c in cols]  # and a column nobody reads
    rows = sum(c.shape[0] for c in cols)
    dY = rhs(rows, k, 3)
    ct, dt = [torch.from_numpy(c) for c in cols], [torch.from_numpy(d) for d in data]
    memo = {("transposed", torch.device("cpu"), n): ops.transposed_slabs(ct, n, torch.device("cpu"), cut=cut)}
    g = ops.ell_slabs_spmm_transposed(ct, dt, torch.from_numpy(dY), n, memo=memo)
    D = _dense_of(cols, data, n)
    _close(g.numpy(), D.T @ dY, 1e-5)
    assert not g.numpy()[11].any()
    # new values through the memoized structure
    dt2 = [2 * d for d in dt]
    _close(ops.ell_slabs_spmm_transposed(ct, dt2, torch.from_numpy(dY), n, memo=memo).numpy(),
           2 * (D.T @ dY), 1e-5)
    assert list(memo) == [("transposed", torch.device("cpu"), n)]
    # it is the gradient autograd takes of the plain K2 with respect to B
    B = torch.zeros(n, k, requires_grad=True)
    (gB,) = torch.autograd.grad(ops.ell_slabs_spmm(ct, dt, B), [B], torch.from_numpy(dY))
    _close(g.numpy(), gB.numpy(), 1e-5)


@pytest.mark.parametrize("cut", [8, 2048])
def test_transposed_pack_is_scipys_transpose(cut):
    """The pack's structure and the values its value index reads, piece by
    piece, rebuilt as a matrix, equal scipy's ``.T`` of the slab matrix; the
    row map sends each uncut row to its own row and each piece to a scratch
    row that the hub join reads."""
    from spmm_tpu_torch.formats import ell_pack
    from spmm_tpu_torch.formats import synthetic as tsyn

    A = tsyn.webgraph_like(300, 2400, seed=18)
    A = dataclasses.replace(A, data=rhs(1, A.nnz_pad, 19)[0] * (np.arange(A.nnz_pad) < A.nnz))
    E = ell_pack(A).to("cpu")
    T = ops.transposed_slabs(E.cols, 300, "cpu", cut=cut)
    flat = np.concatenate([np.asarray(d).reshape(-1) for d in E.data] + [[0.0]])
    r, c, v = [], [], []
    row = 0
    for tc, ti in zip(T.cols, T.vidx):
        R, L = tc.shape
        r.append(np.repeat(T.row_keys[row : row + R], L))
        c.append(tc.numpy().reshape(-1))
        v.append(flat[ti.numpy().reshape(-1)])  # -1 reads the zero at the end
        row += R
    got = sp.coo_matrix((np.concatenate(v), (np.concatenate(r), np.concatenate(c))),
                        shape=(300, sum(x.shape[0] for x in E.cols))).tocsr()
    perm = np.asarray(E.perm)[E.n_empty : 300 - E.n_rest_rows]
    want = A.to_scipy()[perm].T.tocsr()
    assert abs(got - want).max() == 0
    assert (T.hub_rows.numel() > 0) == (cut == 8)
    if cut == 8:
        assert max(int(t.shape[1]) for t in T.cols) <= 8
    dest, keys = T.out_rows.numpy(), T.row_keys
    cut_rows = np.isin(keys, T.hub_rows.numpy())
    np.testing.assert_array_equal(dest[~cut_rows], keys[~cut_rows])
    assert sorted(dest[cut_rows]) == list(range(300, 300 + T.scratch))
    assert set(T.hub_idx.numpy().reshape(-1)) <= set(dest[cut_rows]) | {300 + T.scratch}


@pytest.mark.parametrize("block_shape", [(8, 128), (16, 64), (3, 32)])
def test_transposed_bsr_is_scipys_transpose(block_shape):
    """Aᵀ from A's own blocks: the transposed kernel's plan holds each block
    of A once, grouped by block column, and the product over it (the plain
    version here) is scipy's Aᵀ · dY."""
    from spmm_tpu_torch.formats import csr_to_bsr
    from spmm_tpu_torch.formats import synthetic as tsyn

    A = tsyn.banded_random(301, 64, 0.4, seed=20)
    Ab = csr_to_bsr(A, block_shape)
    bm, bn = block_shape
    G, nsub, gptr, ucols, blk = bsr_kernel.transposed_plan(Ab.block_rows, Ab.block_cols,
                                                           -(-301 // bn), bm, bn)
    assert sorted(blk[blk >= 0]) == list(range(Ab.nblocks))
    for g in range(len(gptr) - 1):  # each group's block rows sorted and distinct
        assert np.all(np.diff(ucols[gptr[g] : gptr[g + 1]]) > 0)
        for u in range(gptr[g], gptr[g + 1]):
            for i in np.nonzero(blk[u] >= 0)[0]:
                b = blk[u, i]
                assert (Ab.block_rows[b], Ab.block_cols[b]) == (ucols[u], g * G + i)
    dY = rhs(301, 128, 21)
    _close(ops.bsr_spmm_transposed(Ab, torch.from_numpy(dY)).numpy(), A.to_scipy().T @ dY)


def test_gradcheck_of_the_plain_versions_fp64():
    g = torch.Generator().manual_seed(0)
    shapes = [(5, 3), (2, 70), (4, 1)]
    cols = [torch.randint(0, 12, s, generator=g, dtype=torch.int32) for s in shapes]
    data = [torch.randn(s, generator=g, dtype=torch.float64).requires_grad_() for s in shapes]
    B = torch.randn(12, 6, generator=g, dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(lambda B, *d: ops.ell_slabs_spmm(cols, d, B), (B, *data))
