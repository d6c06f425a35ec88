"""SpMM over the BlockedCSR format: the port's ``ops/blocked.py`` and
``entry.py`` against the JAX package's ``ops/blocked.py`` and
``__graft_entry__.entry`` (JAX on the CPU) and scipy.

Tolerances: 1e-5 of max |JAX| between the packages (fp32 sums of the same
terms in another order), 1e-4 against scipy, 2e-3 for the 3-step chain (as
the JAX package's own test).  The views are integer gathers of the same
arrays, so they must be equal.  On the CPU the buckets go through K2's plain
version; tests/test_torch_cuda.py holds the kernel path against it on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from spmm_tpu.config import Config as JConfig
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.ops import blocked as jb
from spmm_tpu.preprocess import preprocess as jpreprocess

from spmm_tpu_torch import ops
from spmm_tpu_torch.config import Config
from spmm_tpu_torch.entry import entry
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.ops import blocked as tb
from spmm_tpu_torch.ops import ell_kernel
from spmm_tpu_torch.preprocess import preprocess

from torch_parity import rhs, one_torch_thread  # noqa: F401  (autouse)

CASES = [
    # test_ops.py:146-147 and :225-226 (the slab view, the panel two-stage)
    ("webgraph_like", (3000, 18000), 17, dict(region_budget=1024, panel_rows=512)),
    # test_preprocess.py:201-202 (blocked_spmm_xla)
    ("webgraph_like", (1000, 7000), 10, dict(region_budget=250, panel_rows=128)),
    # test_preprocess.py:216-217 (many empty rows)
    ("random_csr", (600, 600, 0.002), 11, dict(region_budget=100)),
]


def _pair(name, args, seed, cfg):
    Aj = getattr(jsyn, name)(*args, seed=seed)
    At = getattr(tsyn, name)(*args, seed=seed)
    return At, jpreprocess(Aj, JConfig(**cfg)).device(), preprocess(At, Config(**cfg))


def _close_to_jax(y_t, y_j):
    y_j = np.asarray(y_j)
    assert np.abs(y_t.numpy() - y_j).max() <= 1e-5 * max(np.abs(y_j).max(), 1e-30)


@pytest.mark.parametrize("panel", [False, True])
@pytest.mark.parametrize("name,args,seed,cfg", CASES)
def test_slab_view_is_jax_view_in_k2_layout(name, args, seed, cfg, panel):
    """Bucket for bucket, the port's (8G, L) K2 slab is the JAX (G, L, 8)
    tile transposed; the leftover stream, order map and panel are equal."""
    _, Pj, Pt = _pair(name, args, seed, cfg)
    vj = jb.blocked_slab_view(Pj, panel=panel)
    vt = tb.blocked_slab_view(Pt, panel=panel)
    assert len(vt) == len(vj) == (4 if panel else 3)
    assert len(vt[0]) == len(vj[0])
    for (dj, cj), (dt, ct) in zip(vj[0], vt[0]):
        G, L, _ = dj.shape
        assert ct.dtype == torch.int32 and ct.is_contiguous() and dt.is_contiguous()
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj).transpose(0, 2, 1).reshape(8 * G, L))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj).transpose(0, 2, 1).reshape(8 * G, L))
    for u, v in zip(vj[1], vt[1]):
        np.testing.assert_array_equal(v.numpy(), np.asarray(u))
    np.testing.assert_array_equal(vt[2].numpy(), np.asarray(vj[2]))
    if panel:
        np.testing.assert_array_equal(vt[3].numpy(), np.asarray(vj[3]))


@pytest.mark.parametrize("panel", [False, True])
@pytest.mark.parametrize("name,args,seed,cfg", CASES)
def test_blocked_spmm_slab_matches_jax_and_scipy(name, args, seed, cfg, panel):
    At, Pj, Pt = _pair(name, args, seed, cfg)
    B = rhs(At.shape[1], 16, 3)
    vt = tb.blocked_slab_view(Pt, panel=panel)
    Y = tb.blocked_spmm_slab(Pt, torch.from_numpy(B), vt)
    assert Y.dtype == torch.float32 and Y.shape == (At.shape[0], 16)
    _close_to_jax(Y, jb.blocked_spmm_slab(Pj, jnp.asarray(B), jb.blocked_slab_view(Pj, panel=panel)))
    np.testing.assert_allclose(Y.numpy(), At.to_scipy() @ B, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(tb.blocked_spmm_slab_reference(Pt, torch.from_numpy(B), vt), Y)


@pytest.mark.parametrize("name,args,seed,cfg", CASES)
def test_blocked_spmm_xla_and_panel_match_jax(name, args, seed, cfg):
    At, Pj, Pt = _pair(name, args, seed, cfg)
    B = rhs(At.shape[1], 8, 0)
    Bt, Bj = torch.from_numpy(B), jnp.asarray(B)
    ref = At.to_scipy() @ B
    ev_j, ev_t = jb.blocked_exec_view(Pj), tb.blocked_exec_view(Pt)
    for u, v in zip(ev_j, ev_t):
        np.testing.assert_array_equal(v.numpy(), np.asarray(u))
    pv_t = tb.blocked_panel_view(Pt)
    for u, v in zip(jb.blocked_panel_view(Pj), pv_t):
        np.testing.assert_array_equal(v.numpy(), np.asarray(u))
    for y_t, y_j in (
        (tb.blocked_spmm_xla(Pt, Bt), jb.blocked_spmm_xla(Pj, Bj)),
        (tb.blocked_spmm_xla(Pt, Bt, view=ev_t), jb.blocked_spmm_xla(Pj, Bj, view=ev_j)),
        (tb.blocked_spmm_panel(Pt, Bt), jb.blocked_spmm_panel(Pj, Bj)),
        (tb.blocked_spmm_panel(Pt, Bt, view=pv_t), jb.blocked_spmm_panel(Pj, Bj)),
        (tb.blocked_spmm_xla(Pt, Bt, permute_back=False),
         jb.blocked_spmm_xla(Pj, Bj, permute_back=False)),
    ):
        _close_to_jax(y_t, y_j)
    np.testing.assert_allclose(tb.blocked_spmm_xla(Pt, Bt).numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.blocked_spmm_panel(Pt, Bt).numpy(), ref, rtol=1e-4, atol=1e-4)


def test_blocked_chain_spmv_seq_input():
    """test_ops.py:242-260: A^3 x through the gather_rows map, in final order."""
    At, Pj, Pt = _pair("webgraph_like", (1400, 8400), 27, dict(region_budget=512, panel_rows=256))
    x = np.random.default_rng(8).standard_normal(1400).astype(np.float32)
    y = tb.blocked_chain_spmv(Pt, torch.from_numpy(x), 3)
    S = At.to_scipy()
    np.testing.assert_allclose(y.numpy(), S @ (S @ (S @ x)), rtol=2e-3, atol=2e-3)
    _close_to_jax(y, jb.blocked_chain_spmv(Pj, jnp.asarray(x), iters=3))
    P_rect = preprocess(tsyn.random_csr(40, 50, 0.1, seed=1), Config(region_budget=64))
    with pytest.raises(ValueError, match="square"):
        tb.blocked_chain_spmv(P_rect, torch.zeros(50), 1)


def test_blocked_spmm_builds_its_view_and_counts_no_cpu_launch():
    At, _, Pt = _pair(*CASES[0])
    B = torch.from_numpy(rhs(At.shape[1], 4, 1))
    n0 = ell_kernel.launches
    Y = tb.blocked_spmm(Pt, B)
    assert ell_kernel.launches == n0  # CPU tensors take K2's plain version
    torch.testing.assert_close(Y, tb.blocked_spmm(Pt.to("cpu"), B, view=tb.blocked_slab_view(Pt)))
    np.testing.assert_allclose(Y.numpy(), At.to_scipy() @ B.numpy(), rtol=1e-4, atol=1e-4)


def test_entry_matches_graft_entry():
    fn, args = entry("cpu")
    assert fn is ops.blocked_spmm_slab
    Y = fn(*args)
    fj, aj = __graft_entry__.entry()
    Yj = np.asarray(fj(*aj))
    assert Y.shape == Yj.shape == (4096, 128)
    assert all(a.device.type == "cpu" for a in (args[0].data, args[1], args[2][2]))
    _close_to_jax(Y, Yj)
