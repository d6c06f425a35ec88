"""SpMM/SpMV of the port against the JAX package and scipy.

On the CPU the kernel wrappers run their plain PyTorch versions; they are held
against the JAX Pallas kernels in interpret mode (as tests/test_ell_bsr.py runs
them) and against the JAX XLA paths.  Tolerances: fp32 1e-4 (BSR, sums of up
to 128 products in another order), 1e-5 for one ELL slab, 2e-4 for whole ELL
SpMM (rows of up to a few hundred products), and 2e-2 of the max in bf16.
The CUDA kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py.
"""

import dataclasses
import gc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmm_tpu.formats import bsr as jbsr
from spmm_tpu.formats import ell as jell
from spmm_tpu.formats import synthetic as jsyn
# modules, not the same-named functions that spmm_tpu.ops re-exports
jell_spmm = importlib.import_module("spmm_tpu.ops.ell_spmm")
jspmm = importlib.import_module("spmm_tpu.ops.spmm")
from spmm_tpu.ops.pallas_bsr import bsr_spmm_pallas
from spmm_tpu.ops.pallas_ell import ell_slab_spmm_pallas

tspmm_mod = importlib.import_module("spmm_tpu_torch.ops.spmm")
from spmm_tpu_torch import ops
from spmm_tpu_torch.config import Config
from spmm_tpu_torch.formats import csr_to_bsr, ell_pack
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.ops import bsr_kernel, ell_kernel
from spmm_tpu_torch.preprocess import preprocess

from torch_parity import rhs


BSR_CASES = [
    ("banded_random", (300, 64, 0.4)),
    ("random_csr", (512, 512, 0.002)),  # entirely empty block rows
    ("banded_random", (1000, 300, 0.3)),
]


@pytest.mark.parametrize("name,args", BSR_CASES)
@pytest.mark.parametrize("k", [128, 256])
def test_bsr_plain_matches_pallas_and_scipy(name, args, k):
    Aj = getattr(jsyn, name)(*args, seed=8)
    At = getattr(tsyn, name)(*args, seed=8)
    B = rhs(At.shape[1], k, 2)
    Yj = np.asarray(bsr_spmm_pallas(jbsr.csr_to_bsr(Aj).device(), jnp.asarray(B), interpret=True))
    Yt = ops.spmm(csr_to_bsr(At), torch.from_numpy(B))
    assert Yt.dtype == torch.float32 and Yt.shape == (At.shape[0], k)
    np.testing.assert_allclose(Yt.numpy(), Yj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Yt.numpy(), At.to_scipy() @ B, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("block_shape", [(16, 64), (3, 32)])
def test_bsr_other_block_shapes(block_shape):
    A = tsyn.banded_random(301, 64, 0.4, seed=13)
    B = rhs(301, 128, 3)
    Y = ops.bsr_spmm(csr_to_bsr(A, block_shape), torch.from_numpy(B))
    np.testing.assert_allclose(Y.numpy(), A.to_scipy() @ B, rtol=1e-4, atol=1e-4)


def test_bsr_bf16_matches_pallas():
    Aj = jsyn.banded_random(304, 64, 0.4, seed=13)
    At = tsyn.banded_random(304, 64, 0.4, seed=13)
    B = rhs(304, 128, 7)
    ref = At.to_scipy() @ B
    Bj = jbsr.csr_to_bsr(Aj).device()
    Bj = dataclasses.replace(Bj, data=jnp.asarray(Bj.data).astype(jnp.bfloat16))
    Yj = np.asarray(bsr_spmm_pallas(Bj, jnp.asarray(B).astype(jnp.bfloat16), interpret=True))
    Bt = csr_to_bsr(At).to("cpu")
    Bt = dataclasses.replace(Bt, data=Bt.data.bfloat16())
    Yt = ops.spmm(Bt, torch.from_numpy(B).bfloat16())
    assert Yt.dtype == torch.float32
    scale = np.abs(ref).max()
    assert np.abs(Yt.numpy() - ref).max() / scale < 2e-2
    assert np.abs(Yt.numpy() - Yj).max() / scale < 2e-2


def test_bsr_rejects_bad_k_and_device():
    A = csr_to_bsr(tsyn.banded_random(64, 16, 0.5, seed=1))
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.bsr_spmm(A, torch.zeros(64, 100))
    with pytest.raises(ValueError, match="device"):
        ops.bsr_spmm(A, torch.zeros(64, 128, device="meta"))
    with pytest.raises(ValueError):
        ops.bsr_spmm(A, torch.zeros(200, 128))  # more rows than the padded width


@pytest.mark.parametrize("R,L,n", [(16, 5, 64), (40, 1, 10), (8, 33, 300)])
def test_ell_slab_plain_matches_pallas(R, L, n):
    rng = np.random.default_rng(R + L)
    cols = rng.integers(-2, n + 2, (R, L)).astype(np.int32)  # out-of-range ids clamp
    data = rng.standard_normal((R, L)).astype(np.float32)
    B = rng.standard_normal((n, 128)).astype(np.float32)
    Yj = np.asarray(ell_slab_spmm_pallas(jnp.asarray(cols), jnp.asarray(data), jnp.asarray(B),
                                         interpret=True))
    Yt = ops.ell_slab_spmm(torch.from_numpy(cols), torch.from_numpy(data), torch.from_numpy(B))
    np.testing.assert_allclose(Yt.numpy(), Yj, rtol=1e-5, atol=1e-5)


def test_ell_slab_writes_into_out_rows():
    rng = np.random.default_rng(0)
    cols = torch.from_numpy(rng.integers(0, 50, (6, 4)).astype(np.int32))
    data = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((50, 7)).astype(np.float32))
    buf = torch.full((10, 7), -1.0)
    ops.ell_slab_spmm(cols, data, B, out=buf[2:8])
    torch.testing.assert_close(buf[2:8], ops.ell_slab_spmm_reference(cols, data, B))
    assert torch.all(buf[:2] == -1) and torch.all(buf[8:] == -1)
    with pytest.raises(ValueError):
        ops.ell_slab_spmm(cols, data, B, out=buf)
    with pytest.raises(ValueError, match="device"):
        ops.ell_slab_spmm(cols, data, B.to("meta"))


ELL_PACKS = [{}, {"exact_max": 8, "step": 8, "max_len": 32}]  # the 2nd leaves leftover rows


@pytest.mark.parametrize("k", [128, 32, 20])
@pytest.mark.parametrize("pack", ELL_PACKS)
def test_ell_spmm_matches_jax(k, pack):
    Aj = jsyn.webgraph_like(1500, 10000, seed=7)
    At = tsyn.webgraph_like(1500, 10000, seed=7)
    Ej = jell.ell_pack(Aj, **pack).device()
    Et = ell_pack(At, **pack)
    assert np.diff(At.indptr).max() > 64  # rows in the step-rounded classes too
    B = rhs(1500, k, k)
    Yj = np.asarray(jax.jit(jell_spmm.ell_spmm)(Ej, jnp.asarray(B)))
    Yt = ops.ell_spmm(Et, torch.from_numpy(B))
    np.testing.assert_allclose(Yt.numpy(), Yj, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(Yt.numpy(), At.to_scipy().astype(np.float64) @ B, rtol=2e-4, atol=2e-4)
    ys = ops.ell_spmm(Et.to("cpu"), torch.from_numpy(B), permute_back=False)
    torch.testing.assert_close(ys[torch.from_numpy(Et.inv_perm).long()], Yt)


@pytest.mark.parametrize("pack", ELL_PACKS)
def test_ell_spmv_matches_jax(pack):
    Aj = jsyn.webgraph_like(1200, 8000, seed=6)
    At = tsyn.webgraph_like(1200, 8000, seed=6)
    x = np.random.default_rng(1).standard_normal(1200).astype(np.float32)
    yj = np.asarray(jax.jit(jell_spmm.ell_spmv)(jell.ell_pack(Aj, **pack).device(), jnp.asarray(x)))
    yt = ops.spmv(ell_pack(At, **pack), torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), yj, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(yt.numpy(), At.to_scipy() @ x, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pad", [1, 8, 64])
def test_spmm_spmv_xla_match_jax(pad):
    Aj = jsyn.random_csr(300, 200, 0.03, seed=4).pad(pad)
    At = tsyn.random_csr(300, 200, 0.03, seed=4).pad(pad)
    B = rhs(200, 16, 5)
    np.testing.assert_allclose(
        ops.spmm_xla(At, torch.from_numpy(B)).numpy(),
        np.asarray(jspmm.spmm_xla(Aj.device(), jnp.asarray(B))), rtol=1e-5, atol=1e-5,
    )
    x = B[:, 0].copy()
    np.testing.assert_allclose(
        ops.spmv_xla(At.to("cpu"), torch.from_numpy(x)).numpy(),
        np.asarray(jspmm.spmv_xla(Aj.device(), jnp.asarray(x))), rtol=1e-5, atol=1e-5,
    )


def test_spmm_dispatcher_formats(monkeypatch):
    A = tsyn.webgraph_like(600, 4000, seed=10)
    B = torch.from_numpy(rhs(600, 16, 4))
    ref = A.to_scipy() @ B.numpy()
    close = lambda y: np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-4)
    close(ops.spmm(ell_pack(A), B))
    close(ops.spmm(A.pad(8).to("cpu"), B))  # below the threshold: gather + index_add_
    np.testing.assert_allclose(ops.spmv(A, B[:, 0]).numpy(), ref[:, 0], rtol=1e-4, atol=1e-4)
    Bw = torch.from_numpy(rhs(600, 128, 4))
    np.testing.assert_allclose(ops.spmm(csr_to_bsr(A), Bw).numpy(), A.to_scipy() @ Bw.numpy(),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.spmm(preprocess(A, Config(region_budget=256, panel_rows=128)), B)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.spmv(preprocess(A, Config(region_budget=256, panel_rows=128)), B[:, 0])

    # above the threshold the CSR packs to ELL once, memoized per instance
    monkeypatch.setattr(tspmm_mod, "AUTO_ELL_THRESHOLD", 1)
    calls = []
    real = tspmm_mod.ell_pack
    monkeypatch.setattr(tspmm_mod, "ell_pack", lambda *a, **k: calls.append(1) or real(*a, **k))
    A2 = tsyn.webgraph_like(600, 4000, seed=10)
    close(ops.spmm(A2, B))
    np.testing.assert_allclose(ops.spmv(A2, B[:, 0]).numpy(), ref[:, 0], rtol=1e-4, atol=1e-4)
    assert len(calls) == 1 and id(A2) in tspmm_mod._ELL_CACHE
    key = id(A2)
    del A2
    gc.collect()
    assert key not in tspmm_mod._ELL_CACHE


def test_cpu_path_counts_no_launch():
    before = (ell_kernel.launches, bsr_kernel.launches)
    A = tsyn.webgraph_like(300, 2000, seed=3)
    ops.spmm(ell_pack(A), torch.from_numpy(rhs(300, 8, 0)))
    ops.spmm(csr_to_bsr(A), torch.from_numpy(rhs(300, 128, 0)))
    assert (ell_kernel.launches, bsr_kernel.launches) == before
