"""K4 and K5 (``spmm_tpu_torch/ops/slab_kernel.py``, ``csrc/slab_spgemm.cu``)
on the CPU, where the kernels cannot run: their tiling and merge order
emulated in numpy, held against the port's plain ``_merge_block`` and the
JAX package's (``spmm_tpu/ops/slab_spgemm.py:1073``) on the same chunks; the
dispatch; and the slice end to end against the JAX package and scipy.

Tolerance: columns, nuniq and pattern counts exact; values within 2e-5 of
max |ref| in fp32 (the plain merges take differences of prefix sums, about
1 ulp per run, where the kernel sums each run directly), 1e-12 in fp64.
The kernels themselves are held against the plain versions on the card in
``tests/test_torch_cuda.py`` (``test_k4_k5_match_plain``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.ops import slab_spgemm as js

from spmm_tpu_torch import kernels, ops
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.ops import slab_kernel as sk
from spmm_tpu_torch.ops import slab_spgemm as ss

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

_INT_MAX = 2**31 - 1

#: the JAX merge compiled once per chunk shape (op by op it compiles each
#: primitive anew)
_jax_merge = jax.jit(js._merge_block, static_argnames=("L", "R_pad", "accum_dtype", "pattern"))


# ---- the kernel's work order in numpy ----------------------------------------


def _kernel_merge(col, val, accum_dtype, pattern):
    """The merge kernel (K4 b and c) step by step as ``csrc/slab_spgemm.cu``
    takes it, over ``tile_layout``'s tiles: each row padded to lp slots, a
    sort on (column, slot), live run starts counted over each thread's E
    consecutive slots and joined by one exclusive scan, each row's offset
    read at its first slot, each run summed directly in slot order (its
    length in pattern mode), ``_INT_MAX`` / 0 past nuniq.  Also checks that
    every row of the chunk lies in exactly one tile."""
    R_pad, L = col.shape
    lay = sk.tile_layout(L, R_pad, accum_dtype, pattern)
    lp, rows_t, nt = lay.lp, lay.rows, lay.threads
    E = lay.slots // nt
    acc = np.float64 if accum_dtype == torch.float64 else np.float32
    cols_u = np.full((R_pad, L), _INT_MAX, np.int32)
    vals_u = np.zeros((R_pad, L), acc)
    nuniq = np.zeros(R_pad, np.int32)
    seen = np.zeros(R_pad, np.int64)
    for tile in range(lay.tiles):
        rows = np.arange(tile * rows_t, (tile + 1) * rows_t)
        inside = rows < R_pad
        seen[rows[inside]] += 1
        key = np.full((rows_t, lp), _INT_MAX, np.int64)
        v = np.zeros((rows_t, lp), acc)
        key[inside, :L] = col[rows[inside]]
        if not pattern:
            v[inside, :L] = val[rows[inside]]
        slot = np.broadcast_to(np.arange(lp), (rows_t, lp))
        order = np.lexsort((slot, key), axis=-1)
        ks, ss_ = np.take_along_axis(key, order, 1), np.take_along_axis(slot, order, 1)
        prev = np.concatenate([np.full((rows_t, 1), -1), ks[:, :-1]], axis=1)
        start = (ks != _INT_MAX) & (ks != prev)
        flat = start.reshape(-1)
        cnt = flat.reshape(nt, E).sum(1)
        off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        pos = off[:, None] + np.cumsum(flat.reshape(nt, E), 1) - flat.reshape(nt, E)
        pos = pos.reshape(rows_t, lp)
        assert np.array_equal(pos.reshape(-1), np.cumsum(flat) - flat)  # the block scan is the flat one
        rowbase = pos[:, 0]
        nu = start.sum(1)
        for r in np.nonzero(inside)[0]:
            i = rows[r]
            nuniq[i] = nu[r]
            (s,) = np.nonzero(start[r])
            ends = np.append(s[1:], (ks[r] != _INT_MAX).sum())
            out = pos[r, s] - rowbase[r]
            assert np.array_equal(out, np.arange(len(s)))
            cols_u[i, out] = ks[r, s]
            if pattern:
                vals_u[i, out] = ends - s
                continue
            sums = v[r, ss_[r, s]].copy()  # each run summed in slot order, one add at a time
            for k in range(1, int((ends - s).max(initial=1))):
                more = s + k < ends
                sums[more] = sums[more] + v[r, ss_[r, s[more] + k]]
            vals_u[i, out] = sums
    assert np.array_equal(seen, np.ones(R_pad))  # every row of the chunk in one tile
    return cols_u, vals_u, nuniq


def _compare_merges(col, val, accum_dtype, pattern):
    """The emulated kernel against the port's ``_merge_block`` and the JAX
    package's on one chunk; returns the emulated nuniq."""
    R_pad, L = col.shape
    emu = _kernel_merge(col.numpy(), None if val is None else val.numpy(), accum_dtype, pattern)
    port = [x.numpy() for x in ss._merge_block(col, val, accum_dtype=accum_dtype, pattern=pattern)]
    acc = jnp.float64 if accum_dtype == torch.float64 else jnp.float32
    with jax.enable_x64(accum_dtype == torch.float64):
        jout = _jax_merge(jnp.asarray(col.numpy()), None if val is None else jnp.asarray(val.numpy()),
                          L=L, R_pad=R_pad, accum_dtype=acc, pattern=pattern)
        jout = [np.asarray(x) for x in jout]
    tol = 1e-12 if accum_dtype == torch.float64 else 2e-5
    for ref in (port, jout):
        np.testing.assert_array_equal(emu[2], ref[2])
        live = np.arange(L)[None, :] < ref[2][:, None]
        np.testing.assert_array_equal(emu[0][live], ref[0][live])
        if pattern:
            np.testing.assert_array_equal(emu[1][live], ref[1][live])
        else:
            scale = max(float(np.abs(ref[1][live]).max(initial=0)), 1e-30)
            assert float(np.abs(emu[1][live] - ref[1][live]).max(initial=0)) <= tol * scale
    return emu[2]


#: (classes, slot budget) pairs of the chunk cases
_SCHEDULES = {"narrow classes": ((4, 16, 64), 1 << 14), "default classes": (ss.DEFAULT_CLASSES, 1 << 16)}
_MODES = {"pattern": (None, torch.float32), "fp32": (np.float32, torch.float32),
          "fp64": (np.float64, torch.float64)}


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("schedule", sorted(_SCHEDULES))
@pytest.mark.parametrize("W", [1, 4, 8])
def test_kernel_merge_order_matches_both_merges(W, schedule, mode):
    """Every chunk of a webgraph A×A (2,000 nodes) through the emulated
    kernel, the port's and the JAX package's merge: the same columns and
    nuniq, pattern counts exact, values within the stated tolerance; the
    chunks' padded rows come out with nuniq 0."""
    classes, budget = _SCHEDULES[schedule]
    values, acc = _MODES[mode]
    A = tsyn.webgraph_like(2000, 12000, seed=W)
    if values is not None:
        A = dataclasses.replace(A, data=np.random.default_rng(W).standard_normal(A.nnz_pad).astype(values))
    plan = ss.spgemm_plan(A, A, classes=classes, seg_w=W, slot_budget=budget, expand=False, device="cpu",
                          accum_dtype=acc, pattern=values is None)
    sched, _ = ss._chunk_schedule(plan.classes, plan.class_counts, budget)
    assert len(sched) > 1
    for L, R_pad, start, cnt in sched:
        col, val = sk.chunk_fetch(plan, start, cnt, L=L, R_pad=R_pad, W=W, accum_dtype=acc,
                                  pattern=plan.pattern)
        nuniq = _compare_merges(col, val, acc, plan.pattern)
        assert not nuniq[cnt:].any()


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("L", [8, 24, 40, 96])
def test_kernel_merge_order_on_edge_rows(L, mode):
    """Rows the kernel must get right however rare: an all-pad row, a row of
    one repeated column, a row whose pads lie among its columns, a row of
    all-distinct columns and dead padded rows, in one chunk."""
    values, acc = _MODES[mode]
    rng = np.random.default_rng(L)
    R_pad = 16
    col = rng.integers(0, L // 2, (R_pad, L)).astype(np.int32)
    col[0] = _INT_MAX
    col[1] = 5
    col[2, ::3] = _INT_MAX
    col[3] = rng.permutation(10 * L)[:L]
    col[13:] = _INT_MAX
    val = None
    if values is not None:
        val = torch.from_numpy(np.where(col == _INT_MAX, 0, rng.standard_normal((R_pad, L))).astype(values))
    nuniq = _compare_merges(torch.from_numpy(col), val, acc, values is None)
    assert list(nuniq[:4]) == [0, 1, len(np.unique(col[2][col[2] != _INT_MAX])), L]
    assert not nuniq[13:].any()


@pytest.mark.parametrize("pattern", [False, True])
@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [1, 4, 8, 24, 40, 96, 320, 2048, 2560, 4096, 5120, 8192, 16384])
def test_tile_layout_covers_every_row_once(L, acc, pattern):
    """The host's tile layout: rows padded to a power of two, a tile of
    ``TILE_SLOTS`` (one row per CTA where a row is wider), every row of the
    chunk in exactly one tile, ``SLOTS_PER_THREAD`` slots per thread, 128
    to 1,024 threads, the shared memory within a CTA's 232,448 bytes."""
    for R_pad in (8, 1000, 1024, 3 << 10):
        lay = sk.tile_layout(L, R_pad, acc, pattern)
        assert lay.lp >= L and lay.lp & (lay.lp - 1) == 0 and lay.lp < 2 * L + 1
        assert lay.slots == max(sk.TILE_SLOTS[acc], lay.lp)
        assert lay.rows == (1 if L >= sk.TILE_SLOTS[acc] else sk.TILE_SLOTS[acc] // lay.lp)
        owner = np.repeat(np.arange(lay.tiles), lay.rows)
        assert len(owner) >= R_pad and len(owner) - R_pad < lay.rows
        assert np.array_equal(np.bincount(owner[:R_pad], minlength=lay.tiles) > 0, np.ones(lay.tiles, bool))
        assert lay.slots == sk.SLOTS_PER_THREAD * lay.threads and 128 <= lay.threads <= 1024
        assert lay.smem <= 232_448


def test_tile_layout_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match=str(sk.MAX_L)):
        sk.tile_layout(sk.MAX_L + 8, 8, torch.float32, False)
    with pytest.raises(TypeError, match="accum_dtype"):
        sk.tile_layout(64, 8, torch.bfloat16, False)


# ---- the dispatch -------------------------------------------------------------


def _counters():
    return dict(sk.slab_launches), sk.compact_launches


@pytest.mark.parametrize("pattern", [False, True])
def test_cpu_tensors_take_the_plain_versions(pattern):
    """On CPU tensors each dispatcher returns its plain version's result and
    touches no launch counter."""
    A = tsyn.webgraph_like(800, 4800, seed=2)
    if not pattern:
        A = dataclasses.replace(A, data=np.random.default_rng(2).standard_normal(A.nnz_pad).astype(np.float32))
    plan = ss.spgemm_plan(A, A, expand=False, slot_budget=1 << 14, device="cpu", pattern=pattern)
    sched, _ = ss._chunk_schedule(plan.classes, plan.class_counts, plan.slot_budget)
    before = _counters()
    outs = []
    for L, R_pad, start, cnt in sched:
        kw = dict(L=L, R_pad=R_pad, W=plan.seg_w, accum_dtype=torch.float32, pattern=pattern)
        col, val = sk.chunk_fetch(plan, start, cnt, **kw)
        base, bm = sk._chunk_meta(plan.rowmeta, start, cnt, R_pad, L // plan.seg_w)
        col_p, val_p = sk._chunk_fetch(plan, base, bm, **kw)
        assert torch.equal(col, col_p) and (pattern or torch.equal(val, val_p))
        merged = sk.chunk_merge(plan, start, cnt, **kw)
        for x, y, z in zip(merged, sk.slab_merge(col, val, accum_dtype=torch.float32, pattern=pattern),
                           sk._merge_block(col_p, val_p, accum_dtype=torch.float32, pattern=pattern)):
            assert torch.equal(x, y) and torch.equal(x, z)
        outs.append((plan.rows_sorted[start : start + R_pad],) + merged)
    nnz_pad = ss._round_up(plan.npa * plan.seg_w, 1024)
    for x, y in zip(sk.compact_to_csr(outs, nrow=A.nrow, nnz_pad=nnz_pad, dtype=torch.float32, device="cpu"),
                    sk._compact_to_csr(outs, nrow=A.nrow, nnz_pad=nnz_pad, dtype=torch.float32, device="cpu")):
        assert torch.equal(x, y)
    assert _counters() == before


def test_cuda_request_raises_and_never_falls_back(monkeypatch):
    """A tensor the dispatch sends to the card raises when the kernel cannot
    run (here: no kernel library) and never reaches a plain version; no
    launch is counted.  Any device other than the CPU or CUDA raises."""
    A = tsyn.webgraph_like(300, 1800, seed=5)
    plan = ss.spgemm_plan(A, A, expand=True, device="cpu")
    L, R_pad, start, cnt = ss._chunk_schedule(plan.classes, plan.class_counts, plan.slot_budget)[0][0]
    kw = dict(L=L, R_pad=R_pad, W=plan.seg_w, accum_dtype=torch.float32, pattern=plan.pattern)
    calls = []

    def plain(*a, **k):
        calls.append(1)
        raise AssertionError("a plain version ran")

    def no_library():
        raise RuntimeError("no kernel library")

    for name in ("_chunk_fetch", "_chunk_meta", "_merge_block", "_compact_to_csr"):
        monkeypatch.setattr(sk, name, plain)
    monkeypatch.setattr(sk, "_on_card", lambda x, what: True)
    monkeypatch.setattr(kernels, "lib", no_library)
    before = _counters()
    for call in (lambda: sk.chunk_fetch(plan, start, cnt, **kw), lambda: sk.chunk_merge(plan, start, cnt, **kw),
                 lambda: sk.slab_merge(plan.aligned_cols[0], None, accum_dtype=torch.float32, pattern=True)):
        with pytest.raises(RuntimeError, match="no kernel library"):
            call()
    compacted = []
    monkeypatch.setattr(sk, "_launch_compact", lambda *a: compacted.append(a[1:]) or "kernel")
    assert sk.compact_to_csr([], nrow=4, nnz_pad=8, dtype=torch.float32, device="cuda") == "kernel"
    assert compacted == [(4, 8, torch.float32, torch.device("cuda"))]
    assert not calls and _counters() == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="unsupported device"):
        sk.slab_merge(torch.zeros((8, 8), dtype=torch.int32, device="meta"), None, accum_dtype=torch.float32,
                      pattern=True)


def test_class_above_the_limit_raises_up_front_on_cuda(monkeypatch):
    """A class wider than ``MAX_L`` raises before any work on CUDA operands,
    naming the limit: ``check_class_limit`` and, with a card reported, the
    entry points, before their host sizing.  CPU operands take any class."""
    wide = (8, 64, 2 * sk.MAX_L)
    with pytest.raises(ValueError, match=str(sk.MAX_L)):
        sk.check_class_limit(wide, "cuda")
    sk.check_class_limit(wide, "cpu")
    sk.check_class_limit((8, sk.MAX_L), "cuda")
    A = tsyn.webgraph_like(300, 1800, seed=6)
    C = ops.spgemm(A, A, classes=wide, device="cpu")
    S = A.to_scipy()
    np.testing.assert_array_equal(C.indptr, (S @ S).tocsr().indptr)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ss, "_sizing", lambda *a, **k: pytest.fail("sized before the class check"))
    for call in (lambda: ops.spgemm(A, A, classes=wide), lambda: ss.spgemm_plan(A, A, classes=wide),
                 lambda: ss.spgemm_slab_big(A, A, pieces=2, classes=wide)):
        with pytest.raises(ValueError, match=str(sk.MAX_L)):
            call()


# ---- the slice end to end on the CPU ------------------------------------------


def _oracle(M):
    S = M.to_scipy()
    C = (S @ S).tocsr()
    C.sum_duplicates()
    C.sort_indices()
    return C


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("W", [1, 4, 8])
def test_slab_entry_points_match_jax_and_scipy(W, mode):
    """The entry points that reach K4 and K5 on the card -- ``ops.spgemm``
    (cold, plan build, plan reuse), ``spgemm_slab_csr``, the aligned plan's
    numeric phase and the chain -- give the JAX package's ``spgemm_slab``
    and scipy's product: structure exact, values within the tolerance."""
    values, acc = _MODES[mode]
    A = tsyn.webgraph_like(1500, 9000, seed=30 + W)
    Aj = jsyn.webgraph_like(1500, 9000, seed=30 + W)
    if values is not None:
        data = np.random.default_rng(W).standard_normal(A.nnz_pad).astype(values)
        A, Aj = dataclasses.replace(A, data=data), dataclasses.replace(Aj, data=data.copy())
    ref = _oracle(A)
    tol = 1e-12 if acc == torch.float64 else 2e-5
    jacc = jnp.float64 if acc == torch.float64 else jnp.float32
    with jax.enable_x64(acc == torch.float64):
        Cj = js.spgemm_slab(Aj, Aj, seg_w=W, accum_dtype=jacc)
        cj = (np.asarray(Cj.indptr), np.asarray(Cj.indices[: Cj.nnz]), np.asarray(Cj.data[: Cj.nnz]))

    def check(indptr, indices, data):
        for want in (cj, (ref.indptr, ref.indices, ref.data)):
            np.testing.assert_array_equal(np.asarray(indptr, np.int64), np.asarray(want[0], np.int64))
            np.testing.assert_array_equal(np.asarray(indices), want[1])
            np.testing.assert_allclose(np.asarray(data), want[2], rtol=tol, atol=tol)

    ss._PLAN_SEEN.clear()
    ss._PLAN_CACHE.clear()
    old = ss.AUTO_PLAN_MIN_NNZ
    ss.AUTO_PLAN_MIN_NNZ = 1
    try:
        for _ in range(3):
            C = ops.spgemm(A, A, seg_w=W, accum_dtype=acc, device="cpu")
            check(C.indptr, C.indices[: C.nnz], C.data[: C.nnz])
    finally:
        ss.AUTO_PLAN_MIN_NNZ = old
        ss._PLAN_SEEN.clear()
        ss._PLAN_CACHE.clear()
    Cd = ss._csr_to_host(ss.spgemm_slab_csr(A, A, seg_w=W, accum_dtype=acc, device="cpu"))
    check(Cd.indptr, Cd.indices, Cd.data)
    plan = ss.spgemm_plan(A, A, seg_w=W, accum_dtype=acc, device="cpu")
    nnz_pad = ss._round_up(plan.npa * W, 1024)
    for outs in (ss.spgemm_slab_device(A, A, plan, accum_dtype=acc)[0],
                 ss.spgemm_chain_device(plan, 2, accum_dtype=acc)):
        Ch = ss._csr_to_host(ss._csr_of(outs, A.shape, nnz_pad, acc, torch.device("cpu")))
        check(Ch.indptr, Ch.indices, Ch.data)


def test_compaction_drops_entries_past_nnz_pad():
    """K5's plain version with ``nnz_pad`` below the product's nonzeros:
    entries at or past it are dropped, the rest as with room for all."""
    A = tsyn.webgraph_like(600, 3600, seed=8)
    outs, _, plan = ss.spgemm_slab_device(A, A, ss.spgemm_plan(A, A, device="cpu"))
    full = sk.compact_to_csr(outs, nrow=A.nrow, nnz_pad=1 << 16, dtype=torch.float32, device="cpu")
    nnz = int(full[3])
    cut = sk.compact_to_csr(outs, nrow=A.nrow, nnz_pad=nnz // 2, dtype=torch.float32, device="cpu")
    assert torch.equal(cut[2], full[2]) and int(cut[3]) == nnz
    assert torch.equal(cut[1], full[1][: nnz // 2]) and torch.equal(cut[0], full[0][: nnz // 2])
    np.testing.assert_array_equal(full[1][:nnz].numpy(), _oracle(A).indices)
