"""The host tables that drive the CUDA kernels, checked in numpy on the CPU:
K2's work table (``ops/ell_kernel.py: work_table``) and K1's group plan
(``ops/bsr_kernel.py: group_plan``).  Each table must cover every slot or
block exactly once, and a plain execution that follows the table as the
kernel does must equal the per-slab / per-block plain version and the JAX
package (``ell_spmm``, ``bsr_spmm_xla``) on the same seeded inputs.

Tolerance: 1e-5 of the max |reference| (fp32 sums of the same terms in
another order).  The kernels themselves are held against the plain versions
on the card by tests/test_torch_cuda.py.
"""

import dataclasses
import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmm_tpu.formats import bsr as jbsr
from spmm_tpu.formats import ell as jell
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.ops.pallas_bsr import bsr_spmm_xla as j_bsr_spmm_xla

from spmm_tpu_torch import ops
from spmm_tpu_torch.config import Config
from spmm_tpu_torch.formats import csr_to_bsr, ell_pack
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.ops import blocked as tb
from spmm_tpu_torch.ops import bsr_kernel, ell_kernel
from spmm_tpu_torch.preprocess import preprocess

from torch_parity import rhs, one_torch_thread  # noqa: F401  (autouse)

jell_spmm = importlib.import_module("spmm_tpu.ops.ell_spmm")  # spmm_tpu.ops re-exports the function


def _close(y, ref):
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape
    assert np.abs(y - ref).max(initial=0.0) <= 1e-5 * max(np.abs(ref).max(initial=0.0), 1e-30)


# ---- K2: the work table -----------------------------------------------------

#: mixed widths: single long rows (up to 2,048), empty slabs, the split edge
SLAB_SHAPES = [(37, 1), (0, 5), (300, 3), (9, 64), (5, 65), (1, 2048), (64, 8), (2, 130), (0, 200)]


def _slabs(shapes, n, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-2, n + 2, (R, L)).astype(np.int32) for R, L in shapes]  # ids clamp
    data = [rng.standard_normal((R, L)).astype(np.float32) for R, L in shapes]
    return cols, data


def _run_table_plain(meta, items, tpr_log2, cols, data, B):
    """The table executed as the kernel walks it: each whole row's sum, and
    each split row's per-group partial sums added in group order."""
    _, slab, row, e, part = ell_kernel.table_slots(meta, items, tpr_log2)
    out = np.zeros((int(meta[:, 1].sum()), B.shape[1]), np.float32)
    Bc = lambda c: B[np.clip(c, 0, B.shape[0] - 1)]
    for s in np.unique(slab):
        sel = slab == s
        r, ee, pp = row[sel], e[sel], part[sel]
        terms = data[s][r, ee][:, None] * Bc(cols[s][r, ee])
        key = r * (pp.max(initial=0) + 2) + (pp + 1)
        uk, inv = np.unique(key, return_inverse=True)
        sums = np.zeros((len(uk), B.shape[1]), np.float32)
        np.add.at(sums, inv, terms)
        rows_u = uk // (pp.max(initial=0) + 2)
        for r_ in np.unique(rows_u):  # partials in group order
            out[meta[s, 2] + r_] = sums[rows_u == r_].sum(0)
    return out


@pytest.mark.parametrize("tpr_log2", [0, 3, 5])
def test_k2_work_table_covers_every_slot_once(tpr_log2):
    meta, items = ell_kernel.work_table(SLAB_SHAPES, tpr_log2)
    groups = ell_kernel.THREADS >> tpr_log2
    assert items.dtype == np.int32 and meta.dtype == np.int64
    np.testing.assert_array_equal(meta[:, 2], np.cumsum([0] + [R for R, _ in SLAB_SHAPES])[:-1])
    item, slab, row, e, part = ell_kernel.table_slots(meta, items, tpr_log2)
    want = sum(R * L for R, L in SLAB_SHAPES)
    key = np.unique(slab * 10**9 + row * 10**4 + e)
    assert len(slab) == len(key) == want  # every slot exactly once
    for s, (R, L) in enumerate(SLAB_SHAPES):
        mine = items[items[:, 0] == s]
        chunk = int(meta[s, 3])
        if L > ell_kernel.SPLIT_L:  # one item per row, cut over the groups
            assert chunk > 0 and chunk % ell_kernel.UNROLL == 0
            np.testing.assert_array_equal(np.sort(mine[:, 1]), np.arange(R))
            assert -(-L // chunk) <= groups
            sel = slab == s
            np.testing.assert_array_equal(part[sel], e[sel] // chunk)
        else:  # whole rows, one per group
            assert chunk == 0
            np.testing.assert_array_equal(mine[:, 1], np.arange(0, R, groups))
            assert np.all(part[slab == s] == -1)
    # without row keys: slab by slab, row by row
    np.testing.assert_array_equal(np.lexsort((items[:, 1], items[:, 0])), np.arange(len(items)))


@pytest.mark.parametrize("k", [1, 3, 32, 128])
def test_k2_table_executed_plainly_matches_plain_version(k):
    cols, data = _slabs(SLAB_SHAPES, 500, k)
    B = rhs(500, k, k)
    ct, dt = [torch.from_numpy(c) for c in cols], [torch.from_numpy(d) for d in data]
    ref = ops.ell_slabs_spmm(ct, dt, torch.from_numpy(B)).numpy()
    row = 0
    for c, d in zip(ct, dt):  # the multi-slab plain version is the per-slab one
        _close(ref[row : row + c.shape[0]], ops.ell_slab_spmm_reference(c, d, torch.from_numpy(B)))
        row += c.shape[0]
    for aligned in (True, False):
        _, tpr_log2 = ell_kernel.lane_layout(k, aligned)
        meta, items = ell_kernel.work_table(SLAB_SHAPES, tpr_log2)
        _close(_run_table_plain(meta, items, tpr_log2, cols, data, B), ref)


@pytest.mark.parametrize("k", [128, 20])
def test_k2_table_over_an_ell_pack_matches_jax(k):
    Aj = jsyn.webgraph_like(1500, 10000, seed=7)
    At = tsyn.webgraph_like(1500, 10000, seed=7)
    Et = ell_pack(At)
    assert max(c.shape[1] for c in Et.cols) > ell_kernel.SPLIT_L  # split rows too
    B = rhs(1500, k, 3)
    _, tpr_log2 = ell_kernel.lane_layout(k, True)
    meta, items = ell_kernel.work_table([c.shape for c in Et.cols], tpr_log2)
    y = _run_table_plain(meta, items, tpr_log2, list(Et.cols), list(Et.data), B)
    yj = np.asarray(jax.jit(jell_spmm.ell_spmm, static_argnames="permute_back")(
        jell.ell_pack(Aj).device(), jnp.asarray(B), permute_back=False))
    lo = Et.n_empty
    _close(y, yj[lo : lo + len(y)])
    _close(y, ops.ell_spmm(Et, torch.from_numpy(B), permute_back=False)[lo : lo + len(y)])


def test_k2_layout_and_memo():
    assert ell_kernel.lane_layout(128, True) == (4, 5)
    assert ell_kernel.lane_layout(32, True) == (4, 3)
    assert ell_kernel.lane_layout(128, False) == (1, 5)
    assert ell_kernel.lane_layout(3, True) == (1, 2)
    assert ell_kernel.lane_layout(1, True) == (1, 0)
    E = ell_pack(tsyn.webgraph_like(300, 2000, seed=1))
    memo = ell_kernel.table_memo(E)
    assert ell_kernel.table_memo(E) is memo and memo == {}
    assert ell_kernel.table_memo(E.to("cpu")) is not memo  # a moved pack starts afresh
    assert ell_kernel.table_memo((1, 2)) is None
    view = tb.blocked_slab_view(preprocess(tsyn.webgraph_like(600, 4000, seed=2), Config(region_budget=256)))
    assert isinstance(view, tb.SlabView) and ell_kernel.table_memo(view) is not None


def test_k2_items_follow_row_keys():
    """With row keys the items run in the key order of their first rows
    (the ELL's original rows, a view's final-order rows), still covering
    every slot once."""
    rows = sum(R for R, _ in SLAB_SHAPES)
    keys = np.random.default_rng(0).permutation(rows)
    meta, items = ell_kernel.work_table(SLAB_SHAPES, 3, row_keys=keys)
    first = keys[meta[items[:, 0], 2] + items[:, 1]]
    assert np.all(np.diff(first) > 0)
    _, slab, row, e, _ = ell_kernel.table_slots(meta, items, 3)
    assert len(np.unique(slab * 10**9 + row * 10**4 + e)) == len(slab) == sum(R * L for R, L in SLAB_SHAPES)
    P = preprocess(tsyn.webgraph_like(3000, 18000, seed=17), Config(region_budget=1024, panel_rows=512))
    view = tb.blocked_slab_view(P)
    n = sum(int(c.shape[0]) for _, c in view[0])
    assert view.row_keys.shape == (n,)  # the final-order row of each bucket row
    np.testing.assert_array_equal(view[2].numpy()[np.asarray(P.row_perm)[view.row_keys]], np.arange(n))


def test_k2_multi_slab_writes_its_rows_and_rejects_bad_shapes():
    cols, data = _slabs([(3, 2), (0, 4), (5, 7)], 40, 1)
    ct, dt = [torch.from_numpy(c) for c in cols], [torch.from_numpy(d) for d in data]
    B = torch.from_numpy(rhs(40, 6, 2))
    buf = torch.full((10, 6), -1.0)
    ops.ell_slabs_spmm(ct, dt, B, buf[1:9])
    torch.testing.assert_close(buf[1:4], ops.ell_slab_spmm_reference(ct[0], dt[0], B))
    torch.testing.assert_close(buf[4:9], ops.ell_slab_spmm_reference(ct[2], dt[2], B))
    assert torch.all(buf[0] == -1) and torch.all(buf[9] == -1)
    with pytest.raises(ValueError):
        ops.ell_slabs_spmm(ct, dt, B, buf)
    with pytest.raises(ValueError, match="device"):
        ops.ell_slabs_spmm(ct, dt, B.to("meta"))


def _sweep_k2():
    """The repo's top-level sweep_k2.py, imported by path."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sweep_k2.py")
    spec = importlib.util.spec_from_file_location("sweep_k2", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k2_sweep_orders_heaviest_first_and_needs_the_card():
    """sweep_k2.py's baseline order (heaviest items first, given as row
    keys) and its exit without CUDA."""
    sweep = _sweep_k2()
    for tpr_log2 in (0, 3, 5):
        keys = sweep.heaviest_first_keys(SLAB_SHAPES, tpr_log2)
        meta, items = ell_kernel.work_table(SLAB_SHAPES, tpr_log2, row_keys=keys)
        work = np.where(meta[items[:, 0], 3] > 0, meta[items[:, 0], 3], meta[items[:, 0], 0])
        assert np.all(np.diff(work) <= 0)  # heaviest items first
        heavy = items[:, 0] * 10**6 + items[:, 1]
        assert len(np.unique(heavy)) == len(ell_kernel.work_table(SLAB_SHAPES, tpr_log2)[1])
    if not torch.cuda.is_available():
        assert sweep.main() == 1


# ---- K1: the group plan -----------------------------------------------------

BSR_PLAN_CASES = [
    ((8, 128), ("banded_random", (1000, 300, 0.3))),
    ((16, 64), ("banded_random", (301, 64, 0.4))),
    ((3, 32), ("banded_random", (301, 64, 0.4))),  # 21 block rows a group, ragged last
    ((8, 128), ("random_csr", (512, 512, 0.002))),  # empty block rows
]


def _run_plan_plain(Ab, B, plan):
    G, gptr, ucols, blk = plan
    bm, bn = Ab.block_shape
    Bp = np.zeros((-(-Ab.shape[1] // bn) * bn, B.shape[1]), np.float32)
    Bp[: B.shape[0]] = B
    Y = np.zeros((Ab.nbrows * bm, B.shape[1]), np.float32)
    for g in range(len(gptr) - 1):
        for u in range(gptr[g], gptr[g + 1]):
            tile = Bp[ucols[u] * bn : (ucols[u] + 1) * bn]
            for i in range(G):
                if blk[u, i] >= 0:
                    r = (g * G + i) * bm
                    Y[r : r + bm] += np.asarray(Ab.data[blk[u, i]], np.float32) @ tile
    return Y[: Ab.shape[0]]


@pytest.mark.parametrize("block_shape,case", BSR_PLAN_CASES)
def test_k1_group_plan_places_every_block_once(block_shape, case):
    name, args = case
    Ab = csr_to_bsr(getattr(tsyn, name)(*args, seed=8), block_shape)
    G, gptr, ucols, blk = bsr_kernel.group_plan(Ab.block_indptr, Ab.block_cols, block_shape[0])
    assert G == bsr_kernel.ROWS // block_shape[0]
    assert all(a.dtype == np.int32 for a in (gptr, ucols, blk))
    assert len(gptr) - 1 == -(-Ab.nbrows // G) and gptr[0] == 0 and gptr[-1] == len(ucols)
    placed = np.sort(blk[blk >= 0])
    np.testing.assert_array_equal(placed, np.arange(Ab.nblocks))  # each block once
    for g in range(len(gptr) - 1):
        u = slice(gptr[g], gptr[g + 1])
        assert np.all(np.diff(ucols[u]) > 0)  # sorted, distinct
        for i in range(G):
            br = g * G + i
            mine = set(range(Ab.block_indptr[br], Ab.block_indptr[br + 1])) if br < Ab.nbrows else set()
            got = blk[u, i]
            assert set(got[got >= 0]) == mine  # -1 elsewhere
            for uc, b in zip(ucols[u], got):
                if b >= 0:
                    assert Ab.block_rows[b] == br and Ab.block_cols[b] == uc


@pytest.mark.parametrize("block_shape,case", BSR_PLAN_CASES)
def test_k1_plan_executed_plainly_matches_plain_and_jax(block_shape, case):
    name, args = case
    At = getattr(tsyn, name)(*args, seed=8)
    Ab = csr_to_bsr(At, block_shape)
    B = rhs(At.shape[1], 128, 4)
    plan = bsr_kernel.group_plan(Ab.block_indptr, Ab.block_cols, block_shape[0])
    y = _run_plan_plain(Ab, B, plan)
    _close(y, ops.bsr_spmm_reference(Ab, torch.from_numpy(B)))
    Aj = jbsr.csr_to_bsr(getattr(jsyn, name)(*args, seed=8), block_shape)
    _close(y, j_bsr_spmm_xla(Aj.device(), jnp.asarray(B)))


def test_k1_plan_rejects_what_the_kernel_does_not_take():
    Ab = csr_to_bsr(tsyn.banded_random(256, 32, 0.5, seed=2))
    with pytest.raises(ValueError, match="bm"):
        bsr_kernel.group_plan(Ab.block_indptr, Ab.block_cols, 65)
    twice = np.concatenate([Ab.block_cols[:1], Ab.block_cols[:1]])
    with pytest.raises(ValueError, match="share"):
        bsr_kernel.group_plan(np.array([0, 2], np.int32), twice, 8)
    Ab2 = dataclasses.replace(Ab)
    assert "_k1_plans" not in Ab2.__dict__
