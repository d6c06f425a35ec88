"""fp64 parity of the port (mirrors ``tests/test_fp64.py``, its four cases at
its sizes, seeds and tolerances: 1e-13 for SpMM, 1e-12 for SpGEMM and BSR,
exact .mtx round trip), with ``jax.enable_x64`` on the JAX side and the same
containers through both packages.

Every SpMM / SpMV / SDDMM entry point takes ``accum_dtype`` with the JAX
package's default (fp32) and meaning (gathered operands and values are cast
to it; the result has it): fp64 inputs return ``torch.float64`` when asked
to, fp32 by default.  On the CPU the kernel wrappers run their plain
versions; the fp64 instantiations of K1, K2 and K3 are held against them on
the card by ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmm_tpu.formats import bsr as jbsr
from spmm_tpu.formats import ell as jell
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.formats.containers import CSR as JCSR

from spmm_tpu_torch import ops
from spmm_tpu_torch.config import Config
from spmm_tpu_torch.formats import CSR, csr_to_bsr, ell_pack, read_mtx, to_coo, to_csr, write_mtx
from spmm_tpu_torch.formats.convert import from_numpy, to_numpy
from spmm_tpu_torch.preprocess import preprocess

from torch_parity import assert_same, one_torch_thread  # noqa: F401  (autouse)


def _random64(m, n, d, seed):
    A = sp.random(m, n, density=d, random_state=seed, format="csr", dtype=np.float64)
    A.data[:] = np.random.default_rng(seed).standard_normal(len(A.data))
    return A


def _web64(n, nnz, seed):
    """A web graph with seeded fp64 values (a JAX-package CSR, numpy leaves)."""
    A = jsyn.webgraph_like(n, nnz, seed=seed)
    vals = np.random.default_rng(seed).standard_normal(A.nnz_pad) * (np.arange(A.nnz_pad) < A.nnz)
    return dataclasses.replace(A, data=vals)


# ---- the four cases of tests/test_fp64.py ---------------------------------------


def test_spmm_fp64_parity():
    A = _random64(120, 90, 0.05, 0)
    B = np.random.default_rng(1).standard_normal((90, 16))
    with jax.enable_x64():
        from spmm_tpu.ops import spmm_xla as j_spmm_xla

        Aj = JCSR.from_scipy(A).pad(8)
        Yj = np.asarray(j_spmm_xla(Aj.device(), jnp.asarray(B), accum_dtype=jnp.float64))
    At = from_numpy(Aj)
    assert np.asarray(At.data).dtype == np.float64  # carried across without a down-cast
    Y = ops.spmm_xla(At, torch.from_numpy(B), accum_dtype=torch.float64)
    assert Y.dtype == torch.float64
    np.testing.assert_allclose(Y.numpy(), A @ B, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(Y.numpy(), Yj, rtol=1e-13, atol=1e-13)
    y = ops.spmv_xla(At, torch.from_numpy(B[:, 0]), accum_dtype=torch.float64)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), A @ B[:, 0], rtol=1e-13, atol=1e-13)
    # the JAX default: an fp32 accumulate, whatever the inputs
    assert ops.spmm_xla(At, torch.from_numpy(B)).dtype == torch.float32


def test_spgemm_fp64_parity():
    A = _random64(150, 150, 0.04, 2)
    with jax.enable_x64():
        from spmm_tpu.ops.slab_spgemm import spgemm_slab as j_spgemm_slab

        Cj = j_spgemm_slab(JCSR.from_scipy(A), JCSR.from_scipy(A), accum_dtype=jnp.float64)
        Cj_data = np.asarray(Cj.data[: Cj.nnz])
    C = ops.spgemm(CSR.from_scipy(A), CSR.from_scipy(A), accum_dtype=torch.float64, device="cpu")
    ref = (A @ A).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    assert np.array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
    assert np.asarray(C.data).dtype == np.float64
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), ref.data, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), Cj_data, rtol=1e-12, atol=1e-14)


def test_bsr_fp64_parity():
    with jax.enable_x64():
        from spmm_tpu.ops.pallas_bsr import bsr_spmm_xla as j_bsr_spmm_xla
        from spmm_tpu.ops.pallas_bsr import bsr_spmv as j_bsr_spmv

        A = jsyn.banded_random(128, 32, 0.4, seed=3, dtype=np.float64)
        Bj = jbsr.csr_to_bsr(A, (8, 128))
        B = np.random.default_rng(4).standard_normal((A.shape[1], 8))
        Yj = np.asarray(j_bsr_spmm_xla(Bj.device(), jnp.asarray(B)))
        yj = np.asarray(j_bsr_spmv(Bj.device(), jnp.asarray(B[:, 0])))
    Bt = from_numpy(Bj)
    assert np.asarray(Bt.data).dtype == np.float64
    Y = ops.bsr_spmm_xla(Bt, torch.from_numpy(B))  # the plain version: any k
    assert Y.dtype == torch.float64
    ref = A.to_scipy() @ B
    np.testing.assert_allclose(Y.numpy(), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Y.numpy(), Yj, rtol=1e-12, atol=1e-12)
    B128 = np.random.default_rng(5).standard_normal((A.shape[1], 128))
    Yk = ops.bsr_spmm(Bt, torch.from_numpy(B128))
    assert Yk.dtype == torch.float64
    np.testing.assert_allclose(Yk.numpy(), A.to_scipy() @ B128, rtol=1e-12, atol=1e-12)
    y = ops.bsr_spmv(Bt, torch.from_numpy(B[:, 0]))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), yj, rtol=1e-12, atol=1e-12)


def test_mtx_real_values_fp64_roundtrip(tmp_path):
    """Real-valued .mtx ingest preserves fp64 values exactly."""
    A = _random64(40, 30, 0.1, 6)
    p = tmp_path / "t.mtx"
    write_mtx(str(p), to_coo(CSR.from_scipy(A)), pattern=False)
    M = read_mtx(str(p), values="native", dtype=np.float64)
    A2 = to_csr(M, sort_within_row=True, sum_duplicates=True)
    assert np.asarray(A2.data).dtype == np.float64
    assert (abs(A2.to_scipy() - A) > 1e-12 * abs(A)).nnz == 0


# ---- fp64 through the ELL, blocked and SDDMM entry points -----------------------


@pytest.mark.parametrize("k", [1, 16])
def test_ell_spmm_fp64(k):
    A = _web64(300, 2000, 7)
    B = np.random.default_rng(8).standard_normal((300, k))
    with jax.enable_x64():
        from spmm_tpu.ops.ell_spmm import ell_spmm as j_ell_spmm

        Ej = jell.ell_pack(A, max_len=64)
        assert np.asarray(Ej.data[0]).dtype == np.float64
        Yj = np.asarray(j_ell_spmm(Ej.device(), jnp.asarray(B), accum_dtype=jnp.float64))
    Et = from_numpy(Ej)
    assert all(np.asarray(d).dtype == np.float64 for d in Et.data)
    assert_same(Et, ell_pack(from_numpy(A), max_len=64))  # and the port packs the same slabs
    Y = ops.ell_spmm(Et, torch.from_numpy(B), accum_dtype=torch.float64)
    assert Y.dtype == torch.float64
    ref = A.to_scipy() @ B
    np.testing.assert_allclose(Y.numpy(), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Y.numpy(), Yj, rtol=1e-12, atol=1e-12)
    if k == 1:
        y = ops.ell_spmv(Et, torch.from_numpy(B[:, 0]), accum_dtype=torch.float64)
        assert y.dtype == torch.float64
        np.testing.assert_allclose(y.numpy(), ref[:, 0], rtol=1e-12, atol=1e-12)
    assert ops.ell_spmm(Et, torch.from_numpy(B)).dtype == torch.float32  # the default accumulate
    assert ops.spmm(Et, torch.from_numpy(B), accum_dtype=torch.float64).dtype == torch.float64


@pytest.mark.parametrize("form", ["xla", "panel", "slab", "slab_panel", "dispatch", "chain"])
def test_blocked_fp64(form):
    A = _web64(1500, 9000, 23)
    B = np.random.default_rng(9).standard_normal((1500, 8))
    from spmm_tpu.config import Config as JConfig
    from spmm_tpu.ops import blocked as jb
    from spmm_tpu.preprocess import preprocess as j_preprocess

    Pj = j_preprocess(A, JConfig(region_budget=512, panel_rows=256))
    Pt = from_numpy(Pj).to("cpu")
    assert Pt.data.dtype == torch.float64
    assert_same(Pt.host(), preprocess(from_numpy(A), Config(region_budget=512, panel_rows=256)))
    Bt = torch.from_numpy(B)
    S = A.to_scipy()
    with jax.enable_x64():
        Pd, Bj, f64 = Pj.device(), jnp.asarray(B), jnp.float64
        if form == "xla":
            Yj = jb.blocked_spmm_xla(Pd, Bj, accum_dtype=f64)
            Y = ops.blocked_spmm_xla(Pt, Bt, accum_dtype=torch.float64)
        elif form == "panel":
            Yj = jb.blocked_spmm_panel(Pd, Bj, accum_dtype=f64)
            Y = ops.blocked_spmm_panel(Pt, Bt, accum_dtype=torch.float64)
        elif form in ("slab", "slab_panel"):
            panel = form == "slab_panel"
            Yj = jb.blocked_spmm_slab(Pd, Bj, jb.blocked_slab_view(Pd, panel=panel), accum_dtype=f64)
            Y = ops.blocked_spmm_slab(Pt, Bt, ops.blocked_slab_view(Pt, panel=panel),
                                      accum_dtype=torch.float64)
        elif form == "dispatch":
            Yj = jb.blocked_spmm(Pd, Bj, accum_dtype=f64)
            Y = ops.spmm(Pt, Bt, accum_dtype=torch.float64)
        else:
            Yj = jb.blocked_chain_spmv(Pd, Bj[:, 0], 3, accum_dtype=f64)
            Y = ops.blocked_chain_spmv(Pt, Bt[:, 0], 3, accum_dtype=torch.float64)
        Yj = np.asarray(Yj)
    assert Y.dtype == torch.float64 and Yj.dtype == np.float64
    ref = S @ (S @ (S @ B[:, 0])) if form == "chain" else S @ B
    scale = np.abs(ref).max()
    assert np.abs(Y.numpy() - ref).max() <= 1e-12 * scale
    assert np.abs(Y.numpy() - Yj).max() <= 1e-12 * scale


def test_sddmm_fp64():
    A = _web64(200, 1200, 10)
    rng = np.random.default_rng(11)
    U, V = rng.standard_normal((200, 12)), rng.standard_normal((200, 12))
    with jax.enable_x64():
        from spmm_tpu.ops.sddmm import sddmm_values as j_sddmm_values

        vj = np.asarray(j_sddmm_values(A.pad(8).device(), jnp.asarray(U), jnp.asarray(V),
                                       accum_dtype=jnp.float64))
    At = from_numpy(A.pad(8))
    v = ops.sddmm_values(At, torch.from_numpy(U), torch.from_numpy(V), accum_dtype=torch.float64)
    assert v.dtype == torch.float64
    np.testing.assert_allclose(v.numpy()[: A.nnz], vj[: A.nnz], rtol=1e-13, atol=1e-13)
    rows = np.repeat(np.arange(200), np.diff(np.asarray(A.indptr)))
    want = np.einsum("ek,ek->e", U[rows], V[np.asarray(A.indices[: A.nnz])])
    np.testing.assert_allclose(v.numpy()[: A.nnz], want, rtol=1e-13, atol=1e-13)
    C = ops.sddmm(At, torch.from_numpy(U), torch.from_numpy(V), scale_by_values=True,
                  accum_dtype=torch.float64)
    assert C.data.dtype == torch.float64
    np.testing.assert_allclose(C.data.numpy()[: A.nnz], want * np.asarray(A.data[: A.nnz]),
                               rtol=1e-13, atol=1e-13)
    assert ops.sddmm_values(At, torch.from_numpy(U), torch.from_numpy(V)).dtype == torch.float32


def test_k2_and_k3_plain_versions_fp64():
    """The plain versions no longer cast to fp32: fp64 slabs times an fp64 B
    sum and return in fp64 by default, and K3's follows dY."""
    rng = np.random.default_rng(12)
    cols = torch.from_numpy(rng.integers(0, 30, size=(6, 5)).astype(np.int32))
    data = torch.from_numpy(rng.standard_normal((6, 5)))
    B = torch.from_numpy(rng.standard_normal((30, 4)))
    Y = ops.ell_slab_spmm(cols, data, B)
    assert Y.dtype == torch.float64
    want = np.einsum("rl,rlk->rk", data.numpy(), B.numpy()[cols.numpy()])
    np.testing.assert_allclose(Y.numpy(), want, rtol=1e-13, atol=1e-13)
    assert ops.ell_slab_spmm(cols, data, B, accum_dtype=torch.float32).dtype == torch.float32
    assert ops.ell_slab_spmm(cols, data.float(), B.float()).dtype == torch.float32
    assert ops.ell_slab_spmm(cols, data.bfloat16(), B.bfloat16()).dtype == torch.float32
    (g,) = ops.ell_slabs_sddmm([cols], Y, B)
    assert g.dtype == torch.float64
    np.testing.assert_allclose(g.numpy(), np.einsum("rk,rlk->rl", want, B.numpy()[cols.numpy()]),
                               rtol=1e-12, atol=1e-12)


def test_containers_cross_without_down_cast():
    """``from_numpy`` / ``to_numpy`` keep fp64 leaves in every container."""
    import spmm_tpu.formats as jformats
    from spmm_tpu.config import Config as JConfig
    from spmm_tpu.preprocess import preprocess as j_preprocess

    A = _web64(400, 2400, 13)
    Pj = j_preprocess(A, JConfig(region_budget=256, panel_rows=128))
    for obj in (A, jell.ell_pack(A, max_len=32), jbsr.csr_to_bsr(A, (8, 128)), Pj):
        t = from_numpy(obj)
        leaves = t.data if isinstance(t.data, tuple) else (t.data,)
        assert all(np.asarray(d).dtype == np.float64 for d in leaves), type(obj).__name__
        assert_same(to_numpy(t, jformats), obj)
    E = from_numpy(jell.ell_pack(A, max_len=32))
    assert np.asarray(E.rest.data).dtype == np.float64
