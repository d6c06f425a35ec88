"""The port's preprocessing passes against the JAX package's, field by field.

Both packages run the same host passes (numpy + the shared native C++), so
every array must be equal, not merely close.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmm_tpu.config import Config as JConfig
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu import preprocess as jpre
from spmm_tpu.preprocess import reorder as jreorder

from spmm_tpu_torch import native
from spmm_tpu_torch.config import Config
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch import preprocess as tpre

from torch_parity import assert_same, one_torch_thread  # noqa: F401  (autouse)

CASES = [
    # the __graft_entry__.py:27-28 shape
    ("webgraph_like", (4096, 24576), dict(region_budget=2048, panel_rows=512)),
    ("webgraph_like", (3000, 20000), {}),
    ("banded_random", (1500, 200, 0.2), dict(region_budget=300, panel_rows=128)),
    ("random_csr", (700, 500, 0.01), dict(section_size=64, region_budget=100)),
]


def _pair(name, args, seed=0):
    return getattr(jsyn, name)(*args, seed=seed), getattr(tsyn, name)(*args, seed=seed)


@pytest.mark.parametrize("name,args,cfg", CASES)
def test_preprocess_matches_jax(name, args, cfg):
    Aj, At = _pair(name, args)
    a = jpre.preprocess(Aj, JConfig(**cfg))
    b = tpre.preprocess(At, Config(**cfg))
    assert_same(a, b)
    back = tpre.unpack_to_csr(b)
    assert_same(jpre.unpack_to_csr(a), back)
    np.testing.assert_array_equal(back.indptr, At.indptr)
    np.testing.assert_array_equal(back.indices[: At.nnz], At.indices[: At.nnz])


@pytest.mark.parametrize("name,args,cfg", CASES[:3])
def test_passes_match_jax(name, args, cfg):
    Aj, At = _pair(name, args, seed=3)
    cj, ct = JConfig(**cfg), Config(**cfg)
    np.testing.assert_array_equal(
        jpre.dominant_sections(Aj, cj.section_size), tpre.dominant_sections(At, ct.section_size)
    )
    pj, pt = jpre.bitmap_reorder(Aj, cj.section_size), tpre.bitmap_reorder(At, ct.section_size)
    np.testing.assert_array_equal(pj[1], pt[1])
    assert_same(pj[0], pt[0])
    bj = jpre.split_regions(pj[0], cj.region_budget)
    bt = tpre.split_regions(pt[0], ct.region_budget)
    np.testing.assert_array_equal(bj, bt)
    np.testing.assert_array_equal(
        jpre.region_distinct_counts(pj[0], bj), tpre.region_distinct_counts(pt[0], bt)
    )
    lens = np.diff(pt[0].indptr)
    panels = tpre.panelize(lens, bt, ct.panel_rows, ct.group_width)
    np.testing.assert_array_equal(jpre.panelize(lens, bj, cj.panel_rows, cj.group_width), panels)
    sj = jpre.panel_sort(lens, panels, group_width=8, max_len=32)
    st = tpre.panel_sort(lens, panels, group_width=8, max_len=32)
    for u, v in zip(sj, st):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("name,args,cfg", CASES[:2])
def test_numpy_paths_match_native(monkeypatch, name, args, cfg):
    """With the native library switched off every pass takes its numpy path
    and must give the same BlockedCSR (the JAX package's fallbacks)."""
    _, At = _pair(name, args)
    want = tpre.preprocess(At, Config(**cfg))
    assert native.available()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()
    assert_same(want, tpre.preprocess(At, Config(**cfg)))


@pytest.mark.parametrize("name,args,section", [
    ("webgraph_like", (800, 5000), 256),  # test_preprocess.py:46-61
    ("webgraph_like", (4096, 24576), 2048),
    ("random_csr", (700, 500, 0.01), 64),  # empty rows
])
def test_device_reorder_matches_host_and_jax(name, args, section):
    """The torch device path gives the host pass's dominant sections and its
    permutation exactly, and the JAX device path's."""
    Aj, At = _pair(name, args, seed=2)
    At, Aj = At.pad(16), Aj.pad(16)
    dom = tpre.dominant_sections_device(
        torch.from_numpy(At.indices), torch.from_numpy(At.indptr), At.nnz, At.shape, section)
    np.testing.assert_array_equal(dom.numpy(), tpre.dominant_sections(At, section))
    np.testing.assert_array_equal(dom.numpy(), np.asarray(jreorder.dominant_sections_device(
        jnp.asarray(Aj.indices), jnp.asarray(Aj.indptr), Aj.nnz, Aj.shape, section)))
    perm = tpre.bitmap_perm_device(At.to("cpu"), section)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), tpre.bitmap_reorder(At, section, materialize=False)[1])
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jreorder.bitmap_perm_device(Aj, section)))
