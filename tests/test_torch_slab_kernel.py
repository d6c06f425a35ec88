"""K4 and K5 (``spmm_tpu_torch/ops/slab_kernel.py``, ``csrc/slab_spgemm.cu``)
on the CPU, where the kernels cannot run: their tiling, merge order and
compaction emulated in numpy, held against the port's plain
``_merge_block`` / ``_compact_to_csr`` and the JAX package's merge
(``spmm_tpu/ops/slab_spgemm.py:1073``) on the same chunks, and the
natural-run merge (``_run_merge``) held bit-equal to the bitonic kernel it
replaced (``_kernel_merge``, the bit contract of the merge's outputs); K4
(a)'s walk over its pieces and layout (``fetch_plan``) against
``_chunk_fetch``, and the life of a cache whose chunks are views of one
allocation; the dispatch; and the slice end to end against the JAX
package and scipy.

Tolerance: columns, nuniq and pattern counts exact; values within 2e-5 of
max |ref| in fp32 (the plain merges take differences of prefix sums, about
1 ulp per run, where the kernel sums each run directly), 1e-12 in fp64; the
two kernel emulations bit-equal.  The kernels themselves are held against
the plain versions on the card in ``tests/test_torch_cuda.py``
(``test_k4_k5_match_plain``).
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


# ---- the kernels' work orders in numpy ---------------------------------------

#: the bitonic merge kernel's tile (slots of padded rows) per accumulate type
#: and its slots per thread
_BITONIC_TILE = {torch.float32: 4096, torch.float64: 2048}
_BITONIC_PER = 16


def _kernel_merge(col, val, accum_dtype, pattern):
    """The bit contract of the merge's outputs: the bitonic merge kernel that
    the natural-run merge replaced, step by step -- each row padded to lp slots
    (a power of two), a tile of max(tile, lp) padded slots, a sort on
    (column, slot), live run starts counted over each thread's 16
    consecutive slots and joined by one exclusive scan, each row's offset
    read at its first slot, each run summed directly in slot order (its
    length in pattern mode), ``_INT_MAX`` / 0 past nuniq."""
    R_pad, L = col.shape
    acc = np.float64 if accum_dtype == torch.float64 else np.float32
    lp = 1 << (L - 1).bit_length()
    tp = max(_BITONIC_TILE[accum_dtype], lp)
    rows_t, nt, E = tp // lp, tp // _BITONIC_PER, _BITONIC_PER
    cols_u = np.full((R_pad, L), _INT_MAX, np.int32)
    vals_u = np.zeros((R_pad, L), acc)
    nuniq = np.zeros(R_pad, np.int32)
    for tile in range(-(-R_pad // rows_t)):
        rows = np.arange(tile * rows_t, (tile + 1) * rows_t)
        inside = rows < R_pad
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
        pos = (off[:, None] + np.cumsum(flat.reshape(nt, E), 1) - flat.reshape(nt, E)).reshape(rows_t, lp)
        rowbase = pos[:, 0]
        for r in np.nonzero(inside)[0]:
            i = rows[r]
            (st,) = np.nonzero(start[r])
            nuniq[i] = len(st)
            ends = np.append(st[1:], (ks[r] != _INT_MAX).sum())
            out = pos[r, st] - rowbase[r]
            cols_u[i, out] = ks[r, st]
            if pattern:
                vals_u[i, out] = ends - st
                continue
            sums = v[r, ss_[r, st]].copy()  # each run summed in slot order, one add at a time
            for k in range(1, int((ends - st).max(initial=1))):
                more = st + k < ends
                sums[more] = sums[more] + v[r, ss_[r, st[more] + k]]
            vals_u[i, out] = sums
    return cols_u, vals_u, nuniq


def _merge_path(key, a0, a1, b1, d):
    """The kernel's merge-path search, vectorized: items of the left run
    [a0, a1) among the first d outputs of its merge with [a1, b1), ties to
    the left run."""
    lo, hi = np.maximum(0, d - (b1 - a1)), np.minimum(d, a1 - a0)
    while (lo < hi).any():
        go = lo < hi
        mid = (lo + hi) >> 1
        right_first = key[np.where(go, a1 + d - 1 - mid, 0)] < key[np.where(go, a0 + mid, 0)]
        hi = np.where(go & right_first, mid, hi)
        lo = np.where(go & ~right_first, mid + 1, lo)
    return lo


def _tile_merge(key, v, L, rows, threads, items, acc, pattern):
    """One tile of the natural-run merge (``csrc/slab_spgemm.cu``:
    slab_merge_kernel) on its rows' S = rows * L slots in slot order: run
    starts (a row's first slot, a column below its predecessor), each row's
    live length (after its last non-pad slot), the starts listed by one
    block scan over the threads' ``items`` consecutive slots, then merge
    rounds -- round r merges runs [g 2^r, g 2^r + 2^(r-1)) with the next
    2^(r-1), stably, each thread's first slot placed by the kernel's
    merge-path search (checked here against the stable merge) -- and the
    runs of equal columns summed in slot order.  Returns the rows' merged
    columns, values and nuniq."""
    S = rows * L
    p = np.arange(S)
    row, e = p // L, p % L
    key = key.astype(np.int64).copy()
    live_slot = key != _INT_MAX
    n_row = np.zeros(rows, np.int64)
    np.maximum.at(n_row, row[live_slot], e[live_slot] + 1)
    prev = np.concatenate([[_INT_MAX], key[:-1]])
    start = (e == 0) | (key < prev)
    flags = np.zeros(threads * items, bool)
    flags[:S] = start
    cnt = flags.reshape(threads, items).sum(1)
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    scanned = (off[:, None] + np.cumsum(flags.reshape(threads, items), 1) - flags.reshape(threads, items)).reshape(-1)
    assert np.array_equal(scanned[:S], np.cumsum(start) - start)  # the block scan is the flat one
    run = np.cumsum(start) - 1
    base = run[e == 0]  # each row's first run
    ri = run - base[row]  # a slot's run within its row (fixed by position, not by item)
    m = np.bincount(row[start], minlength=rows)
    rstart = e[start]  # the run starts, row by row
    first_run = np.concatenate([[0], np.cumsum(m)[:-1]])
    most = int(m.max(initial=0))
    rounds = 0 if most <= 1 else (most - 1).bit_length()
    live = e < n_row[row]
    idx = np.nonzero(live)[0]

    def run_start(r_, k):  # start of run k of row r_, or the row's live end past its last run
        return np.where(k < m[r_], rstart[first_run[r_] + np.minimum(k, m[r_] - 1)], n_row[r_])

    for r in range(1, rounds + 1):
        g0 = (ri >> r) << r
        gs, gm, ge = run_start(row, g0), run_start(row, g0 + (1 << (r - 1))), run_start(row, g0 + (1 << r))
        order = np.lexsort((p[idx], key[idx], (row * (L + 1) + (ri >> r))[idx]))
        src = idx[order]
        new_key, new_v = key.copy(), v.copy()
        new_key[idx], new_v[idx] = key[src], v[src]
        from_left = np.zeros(S + 1, np.int64)
        from_left[1:][idx] = src < (row * L + gm)[src]
        cum = np.cumsum(from_left)
        # each thread's first slot in a merge: the kernel's merge-path search
        o = np.arange(0, S, items)
        o = o[live[o] & (gm[o] < ge[o])]
        a0, a1, b1 = (row * L + gs)[o], (row * L + gm)[o], (row * L + ge)[o]
        d = o - a0
        assert np.array_equal(_merge_path(key, a0, a1, b1, d), cum[o] - cum[a0])
        key, v = new_key, new_v
    ks = key
    assert all((np.diff(ks[rr * L : rr * L + n_row[rr]]) >= 0).all() for rr in range(rows))
    prev = np.concatenate([[_INT_MAX], ks[:-1]])
    ust = (ks != _INT_MAX) & ((e == 0) | (ks != prev))
    nuniq = np.bincount(row[ust], minlength=rows)
    cols_u = np.full((rows, L), _INT_MAX, np.int32)
    vals_u = np.zeros((rows, L), acc)
    for rr in range(rows):
        seg = ks[rr * L : (rr + 1) * L]
        (st,) = np.nonzero(ust[rr * L : (rr + 1) * L])
        ends = np.append(st[1:], (seg != _INT_MAX).sum())
        cols_u[rr, : len(st)] = seg[st]
        if pattern:
            vals_u[rr, : len(st)] = ends - st
            continue
        vv = v[rr * L : (rr + 1) * L]
        sums = vv[st].astype(acc)  # each run summed in slot order, one add at a time
        for k in range(1, int((ends - st).max(initial=1))):
            more = st + k < ends
            sums[more] = sums[more] + vv[st[more] + k]
        vals_u[rr, : len(st)] = sums
    return cols_u, vals_u, nuniq


def _run_merge(cols, vals, accum_dtype, pattern):
    """The merge kernel (K4 b and c) over a product's chunks as
    ``csrc/slab_spgemm.cu`` takes them: ``merge_plan``'s launches, each
    tile finding its chunk in its launch's table, ``_tile_merge`` on its
    rows.  Checks that every row of every chunk lies in exactly one tile.
    Returns (cols_u, vals_u, nuniq) per chunk."""
    acc = np.float64 if accum_dtype == torch.float64 else np.float32
    shapes = [(c.shape[1], c.shape[0]) for c in cols]
    plan = sk.merge_plan(shapes, accum_dtype)
    f = {name: i for i, name in enumerate(sk.MERGE_FIELDS)}
    outs = [(np.full(c.shape, _INT_MAX, np.int32), np.zeros(c.shape, acc), np.zeros(c.shape[0], np.int32))
            for c in cols]
    seen = [np.zeros(c.shape[0], np.int64) for c in cols]
    for x in plan.launches:
        assert len(x.chunks) <= sk.MAX_LAUNCH_CHUNKS and x.smem <= 232_448
        for tile in range(x.tiles):
            k = int(np.searchsorted(x.table[:, f["tile0"]], tile, side="right")) - 1
            ci, t = x.chunks[k], x.table[k]
            L, R_pad, rows_t = int(t[f["L"]]), int(t[f["R_pad"]]), int(t[f["rows_t"]])
            assert (L, R_pad) == shapes[ci] and rows_t * L <= x.slots
            r0 = (tile - int(t[f["tile0"]])) * rows_t
            rows = min(rows_t, R_pad - r0)
            assert rows > 0
            seen[ci][r0 : r0 + rows] += 1
            key = cols[ci][r0 : r0 + rows].reshape(-1)
            v = np.zeros(rows * L, acc) if pattern else vals[ci][r0 : r0 + rows].reshape(-1).astype(acc)
            cu, vu, nu = _tile_merge(key, v, L, rows, x.threads, x.items, acc, pattern)
            outs[ci][0][r0 : r0 + rows], outs[ci][1][r0 : r0 + rows], outs[ci][2][r0 : r0 + rows] = cu, vu, nu
    assert all(np.array_equal(s_, np.ones_like(s_)) for s_ in seen)  # every row of every chunk in one tile
    return outs


def _compare_merges(cols, vals, accum_dtype, pattern):
    """The emulated kernel over the chunks ``cols`` / ``vals`` (tensors)
    against the port's ``_merge_block`` and the JAX package's, and bit-equal
    to the bitonic kernel's contract; returns the emulated nuniq per chunk."""
    emu = _run_merge([c.numpy() for c in cols], [None if v is None else v.numpy() for v in vals],
                        accum_dtype, pattern)
    tol = 1e-12 if accum_dtype == torch.float64 else 2e-5
    for col, val, got in zip(cols, vals, emu):
        R_pad, L = col.shape
        old = _kernel_merge(col.numpy(), None if val is None else val.numpy(), accum_dtype, pattern)
        for x, y in zip(got, old):
            np.testing.assert_array_equal(x, y)
        port = [x.numpy() for x in ss._merge_block(col, val, accum_dtype=accum_dtype, pattern=pattern)]
        acc = jnp.float64 if accum_dtype == torch.float64 else jnp.float32
        with jax.enable_x64(accum_dtype == torch.float64):
            jout = _jax_merge(jnp.asarray(col.numpy()), None if val is None else jnp.asarray(val.numpy()),
                              L=L, R_pad=R_pad, accum_dtype=acc, pattern=pattern)
            jout = [np.asarray(x) for x in jout]
        for ref in (port, jout):
            np.testing.assert_array_equal(got[2], ref[2])
            live = np.arange(L)[None, :] < ref[2][:, None]
            np.testing.assert_array_equal(got[0][live], ref[0][live])
            if pattern:
                np.testing.assert_array_equal(got[1][live], ref[1][live])
            else:
                scale = max(float(np.abs(ref[1][live]).max(initial=0)), 1e-30)
                assert float(np.abs(got[1][live] - ref[1][live]).max(initial=0)) <= tol * scale
    return [x[2] for x in emu]


#: (classes, slot budget) pairs of the chunk cases
_SCHEDULES = {"narrow classes": ((4, 16, 64), 1 << 14), "default classes": (ss.DEFAULT_CLASSES, 1 << 16)}
_MODES = {"pattern": (None, torch.float32), "fp32": (np.float32, torch.float32),
          "fp64": (np.float64, torch.float64)}


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("schedule", sorted(_SCHEDULES))
@pytest.mark.parametrize("W", [1, 4, 8])
def test_kernel_merge_order_matches_both_merges(W, schedule, mode):
    """Every chunk of a webgraph A×A (2,000 nodes) through the emulated
    kernel (the product's tile table), the port's and the JAX package's
    merge: the same columns and nuniq, pattern counts exact, values within
    the stated tolerance, bit-equal to the bitonic kernel's contract; the
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
    slabs = [sk.chunk_fetch(plan, start, cnt, L=L, R_pad=R_pad, W=W, accum_dtype=acc, pattern=plan.pattern)
             for L, R_pad, start, cnt in sched]
    nuniq = _compare_merges([c for c, _ in slabs], [v for _, v in slabs], acc, plan.pattern)
    for nu, (_, _, _, cnt) in zip(nuniq, sched):
        assert not nu[cnt:].any()


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
    (nuniq,) = _compare_merges([torch.from_numpy(col)], [val], acc, values is None)
    assert list(nuniq[:4]) == [0, 1, len(np.unique(col[2][col[2] != _INT_MAX])), L]
    assert not nuniq[13:].any()


def _desc_b(M):
    """M with each row's columns in descending order (a CSR whose rows do
    not ascend)."""
    ind = M.indices.copy()
    for r in range(M.nrow):
        a, b = M.indptr[r], M.indptr[r + 1]
        ind[a:b] = ind[a:b][::-1]
    return dataclasses.replace(M, indices=ind)


def _dup_b(M):
    """M with each row of two or more entries repeating its first column in
    its second slot (a row with a column twice)."""
    ind = M.indices.copy()
    lens = np.diff(M.indptr)
    rows = np.nonzero(lens >= 2)[0]
    ind[M.indptr[rows] + 1] = ind[M.indptr[rows]]
    return dataclasses.replace(M, indices=ind)


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("kind", ["B rows descending", "B rows repeating a column"])
def test_kernel_merge_order_on_unsorted_b(kind, mode):
    """A product whose B rows do not ascend or repeat a column gives more
    and shorter runs, and the same merge: every chunk of the aligned cache
    through the emulated kernel, both plain merges and the bitonic
    contract."""
    values, acc = _MODES[mode]
    A = tsyn.webgraph_like(1500, 9000, seed=11)
    if values is not None:
        A = dataclasses.replace(A, data=np.random.default_rng(11).standard_normal(A.nnz_pad).astype(values))
    B = _desc_b(A) if kind == "B rows descending" else _dup_b(A)
    plan = ss.spgemm_plan(A, B, device="cpu", accum_dtype=acc, pattern=values is None, slot_budget=1 << 16)
    assert len(plan.aligned_cols) > 1
    vals = list(plan.aligned_vals) or [None] * len(plan.aligned_cols)
    _compare_merges(list(plan.aligned_cols), vals, acc, values is None)


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("kind", ["one run", "one-slot runs"])
def test_kernel_merge_order_on_run_counts(kind, mode):
    """The extremes of a row's runs: every row one ascending run with
    repeated columns (no merge round), and every row L one-slot runs
    (strictly descending columns, log2(L) rounds); one row cut short by
    pads."""
    values, acc = _MODES[mode]
    rng = np.random.default_rng(3)
    L, R_pad = 40, 64
    if kind == "one run":
        col = np.sort(rng.integers(0, 30, (R_pad, L)), axis=1)  # ascending, with repeats
    else:
        col = 3 * np.arange(L)[::-1] + rng.integers(0, 3, (R_pad, 1))  # each slot below its predecessor
    col = col.astype(np.int32)
    col[5, 30:] = _INT_MAX  # a row cut short
    val = None
    if values is not None:
        val = torch.from_numpy(np.where(col == _INT_MAX, 0, rng.standard_normal((R_pad, L))).astype(values))
    _compare_merges([torch.from_numpy(col)], [val], acc, values is None)


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("L", [24, 1000, 5000, 12000, 16384])
def test_kernel_merge_order_on_wide_rows(L, mode):
    """Rows that are not powers of two, up to the widest class (``MAX_L``):
    runs of random lengths (B rows of 1-40 columns), pads at their ends, one
    tile per row above 8,192 slots; the wide block-size group."""
    values, acc = _MODES[mode]
    rng = np.random.default_rng(L)
    R_pad = max(2, 8192 // L)
    col = np.full((R_pad, L), _INT_MAX, np.int32)
    for r in range(R_pad):
        e = 0
        while e < L - 40:
            n = int(rng.integers(1, 41))
            col[r, e : e + n] = np.sort(rng.integers(0, 4 * L, n))
            e += n + int(rng.integers(0, 3))  # pads between runs
    val = None
    if values is not None:
        val = torch.from_numpy(np.where(col == _INT_MAX, 0, rng.standard_normal((R_pad, L))).astype(values))
    _compare_merges([torch.from_numpy(col)], [val], acc, values is None)


@pytest.mark.parametrize("pattern", [False, True])
@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [1, 4, 8, 24, 40, 96, 320, 2048, 2560, 4096, 5120, 8192, 16384])
def test_merge_plan_covers_every_row_once(L, acc, pattern):
    """The host's chunk tables over a product of chunks of class L and of
    other classes: each chunk in the launch of its block-size group, tiles
    of min(T // L, R_pad) unpadded rows numbered on across the launch's
    chunks, every row of every chunk in exactly one tile, the outputs laid
    out chunk after chunk, the shared memory within a CTA's 232,448 bytes;
    (b) tables carry each chunk's start and count, (c) tables its slabs."""
    shapes = [(L, R) for R in (8, 1000, 1024, 3 << 10)] + [(8, 100), (16384 if L <= 4096 else 16, 3), (24, 0)]
    n = len(shapes)
    kw = dict(starts=list(range(10, 10 + n)), counts=[max(R - 1, 0) for _, R in shapes]) if pattern else \
        dict(col_ptrs=[1000 + i for i in range(n)], val_ptrs=[2000 + i for i in range(n)])
    plan = sk.merge_plan(shapes, acc, **kw)
    f = {name: i for i, name in enumerate(sk.MERGE_FIELDS)}
    seen = [np.zeros(R, np.int64) for _, R in shapes]
    assert len(plan.launches) == len({sk.merge_group(L_) for L_, R in shapes if R})
    for x in plan.launches:
        widest, threads, items = sk.MERGE_GROUPS[x.group]
        assert (x.threads, x.items) == (threads, items) and x.smem <= 232_448
        assert x.smem == sk.merge_smem(x.group, acc, x.rows_cap)
        tile0 = 0
        for k, i in enumerate(x.chunks):
            L_, R = shapes[i]
            t = x.table[k]
            assert sk.merge_group(L_) == x.group and L_ <= widest and R > 0
            assert (t[f["L"]], t[f["R_pad"]], t[f["tile0"]]) == (L_, R, tile0)
            assert t[f["out_slot"]] == plan.slot_off[i] and t[f["out_row"]] == plan.row_off[i]
            if pattern:
                assert (t[f["start"]], t[f["count"]], t[f["col_ptr"]]) == (10 + i, R - 1, 0)
            else:
                assert (t[f["col_ptr"]], t[f["val_ptr"]], t[f["count"]]) == (1000 + i, 2000 + i, R)
            rows_t = int(t[f["rows_t"]])
            assert rows_t == min(threads * items // L_, R) and rows_t <= x.rows_cap
            ntile = -(-R // rows_t)
            for tile in range(ntile):
                seen[i][tile * rows_t : (tile + 1) * rows_t] += 1
            tile0 += ntile
        assert x.tiles == tile0
    assert all(np.array_equal(s_, np.ones_like(s_)) for s_ in seen)
    assert plan.slot_off == tuple(np.cumsum([0] + [L_ * R for L_, R in shapes])[:-1])
    assert plan.slots == sum(L_ * R for L_, R in shapes) and plan.rows == sum(R for _, R in shapes)


def test_merge_plan_splits_a_group_of_many_chunks():
    """A block-size group of more chunks than one launch's parameter table
    holds (``MAX_LAUNCH_CHUNKS``) takes more launches, each numbering its
    own tiles from 0, every chunk in exactly one."""
    shapes = [(16, 100 + i) for i in range(2 * sk.MAX_LAUNCH_CHUNKS + 5)]
    plan = sk.merge_plan(shapes, torch.float32)
    assert [len(x.chunks) for x in plan.launches] == [sk.MAX_LAUNCH_CHUNKS, sk.MAX_LAUNCH_CHUNKS, 5]
    assert sorted(i for x in plan.launches for i in x.chunks) == list(range(len(shapes)))
    assert all(x.table[0, sk.MERGE_FIELDS.index("tile0")] == 0 for x in plan.launches)


def test_merge_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match=str(sk.MAX_L)):
        sk.merge_plan([(8, 4), (sk.MAX_L + 8, 8)], torch.float32)
    with pytest.raises(TypeError, match="accum_dtype"):
        sk.merge_plan([(64, 8)], torch.bfloat16)


def _compaction_walk(outs, nrow: int, nnz_pad: int, acc):
    """K5 as ``csrc/slab_spgemm.cu`` takes it: ``compact_plan``'s launches;
    the count pass (each chunk row with entries stores its nuniq at its row
    id), the indptr scan, then the copy pass, a thread per slot of a merged
    row copying the slots below the row's nuniq to indptr[row id] on, and
    the padding [nnz, nnz_pad) zeroed.  Checks that every live entry is
    copied exactly once."""
    shapes = [tuple(o[1].shape[::-1]) for o in outs]
    parts = sk.compact_plan(shapes)
    f = {name: i for i, name in enumerate(sk.COMPACT_FIELDS)}
    counts = np.zeros(nrow, np.int64)
    for tab, idx, rtot, _ in parts:
        assert len(idx) <= sk.MAX_LAUNCH_CHUNKS and rtot == sum(shapes[i][1] for i in idx)
        for k, i in enumerate(idx):
            r, nu = outs[i][0].numpy(), outs[i][3].numpy()
            assert tab[k, f["row0"]] == sum(shapes[j][1] for j in idx[:k])
            live = nu > 0
            counts[r[live]] = nu[live]
    indptr = np.concatenate([[0], np.cumsum(counts)])
    data = np.full(nnz_pad, np.nan, acc)
    indices = np.full(nnz_pad, -1, np.int64)
    copied = np.zeros(nnz_pad, np.int64)
    for tab, idx, _, stot in parts:
        q = np.arange(stot)
        k = np.searchsorted(tab[:, f["slot0"]], q, side="right") - 1
        L = tab[k, f["L"]]
        local = q - tab[k, f["slot0"]]
        i, e = local // L, local % L
        for kk, ci in enumerate(idx):
            sel = k == kk
            r, cols_u, vals_u, nu = (x.numpy() for x in outs[ci])
            ii, ee = i[sel], e[sel]
            keep = ee < nu[ii]
            d = indptr[r[ii[keep]]] + ee[keep]
            src = local[sel][keep]
            inside = d < nnz_pad
            np.add.at(copied, d[inside], 1)
            indices[d[inside]] = cols_u.reshape(-1)[src[inside]]
            data[d[inside]] = vals_u.reshape(-1)[src[inside]]
    nnz = int(indptr[-1])
    data[nnz:] = 0
    indices[nnz:] = 0
    assert np.array_equal(copied[: min(nnz, nnz_pad)], np.ones(min(nnz, nnz_pad), np.int64))
    return data, indices.astype(np.int32), indptr, nnz


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("mode", ["pattern", "fp32"])
def test_compaction_walk_covers_every_entry_once(mode, cut):
    """K5's work order on a product's chunk outputs (padded rows repeating
    other rows' ids with nuniq 0) equals ``_compact_to_csr``, padding
    included: every live entry copied once, entries at or past nnz_pad
    dropped, zeros past nnz."""
    values, acc = _MODES[mode]
    A = tsyn.webgraph_like(1200, 7200, seed=21)
    if values is not None:
        A = dataclasses.replace(A, data=np.random.default_rng(21).standard_normal(A.nnz_pad).astype(values))
    outs, _, plan = ss.spgemm_slab_device(A, A, ss.spgemm_plan(A, A, device="cpu", slot_budget=1 << 14,
                                                                pattern=values is None))
    assert len(outs) > 1
    full = sk._compact_to_csr(outs, nrow=A.nrow, nnz_pad=1 << 20, dtype=acc, device="cpu")
    nnz_pad = int(full[3]) // 2 if cut else int(full[3]) + 1000
    want = sk._compact_to_csr(outs, nrow=A.nrow, nnz_pad=nnz_pad, dtype=acc, device="cpu")
    data, indices, indptr, nnz = _compaction_walk(outs, A.nrow, nnz_pad, np.float32)
    np.testing.assert_array_equal(data, want[0].numpy())
    np.testing.assert_array_equal(indices, want[1].numpy())
    np.testing.assert_array_equal(indptr, want[2].numpy())
    assert nnz == int(want[3])


# ---- K4 (a): the fetch's layout and walk --------------------------------------

#: the fetch kernels' CTA size and the piece kernel's pieces per thread
#: (``csrc/slab_spgemm.cu``: kFetchThreads, kFetchPieces)
_FETCH_NT, _FETCH_U = 256, 4

#: (slot budget, W): the default schedule and one of more chunks than a
#: launch takes (``MAX_LAUNCH_CHUNKS``), at the piece kernel's W (4, 8) and
#: the slot kernel's (1)
_FETCH_CASES = [(1 << 24, 8), (1 << 24, 4), (1 << 10, 8), (1 << 10, 4), (1 << 10, 1)]


def _fetch_plan_of(W, mode, budget, seed=40):
    """A product's plan (no cache) and its chunk schedule."""
    values, _ = _MODES[mode]
    A = tsyn.webgraph_like(1500, 9000, seed=seed)
    if values is not None:
        A = dataclasses.replace(A, data=np.random.default_rng(seed).standard_normal(A.nnz_pad).astype(values))
    plan = ss.spgemm_plan(A, A, seg_w=W, slot_budget=budget, expand=False, device="cpu", pattern=values is None)
    sched, _ = ss._chunk_schedule(plan.classes, plan.class_counts, plan.slot_budget)
    return plan, sched


def _fetch_walk(t, sched, W, acc, pattern):
    """K4 (a) as ``csrc/slab_spgemm.cu`` takes it: ``fetch_plan``'s launches;
    thread tid of CTA b takes pieces b * U * NT + u * NT + tid (the piece
    kernel, W % 4 == 0: U = 4 pieces inside one pa block each; the slot
    kernel: U = 1, four slots that may change row and block), finds its
    chunk, row, block and first slot, and fills the piece through rowmeta →
    pa_b2row → the B2 segment.  Returns the one allocation's columns and
    values (None in pattern mode) and how often each slot was written."""
    fp = sk.fetch_plan(sched, W)
    f = {name: i for i, name in enumerate(sk.FETCH_FIELDS)}
    rowmeta = t.rowmeta.numpy().astype(np.int64)
    pa_b2row = t.pa_b2row.numpy().astype(np.int64)
    b2_cols = t.b2_cols.numpy().reshape(-1)
    npa_pad, last_seg = len(pa_b2row), t.b2_cols.shape[0] - 1
    np_acc = np.float64 if acc == torch.float64 else np.float32
    col = np.full(fp.slots, -1, np.int64)
    val = None if pattern else np.zeros(fp.slots, np_acc)
    writes = np.zeros(fp.slots, np.int64)
    vec = W % 4 == 0
    U = _FETCH_U if vec else 1
    for x in fp.launches:
        tab = x.table
        assert np.all(np.diff(tab[:, f["piece0"]]) > 0)  # the kernel's advance over chunks is a search
        per = U * _FETCH_NT
        b, u, tid = np.meshgrid(np.arange(-(-x.pieces // per)), np.arange(U), np.arange(_FETCH_NT), indexing="ij")
        p = (b * per + u * _FETCH_NT + tid).reshape(-1)
        p = p[p < x.pieces]
        k = np.searchsorted(tab[:, f["piece0"]], p, side="right") - 1
        L, R = tab[k, f["L"]], tab[k, f["R_pad"]]
        local = p - tab[k, f["piece0"]]
        if vec:
            per_row = L // 4
            i, e = local // per_row, (local % per_row) * 4
            assert np.array_equal(e // W, (e + 3) // W)  # a piece lies in one pa block
            i, e = np.repeat(i, 4), np.repeat(e, 4) + np.tile(np.arange(4), len(p))
            out = np.repeat(tab[k, f["out_slot"]] + 4 * local, 4) + np.tile(np.arange(4), len(p))
            k, L, R = np.repeat(k, 4), np.repeat(L, 4), np.repeat(R, 4)
        else:
            s = np.repeat(4 * local, 4) + np.tile(np.arange(4), len(p))
            k, L, R = np.repeat(k, 4), np.repeat(L, 4), np.repeat(R, 4)
            keep = s < R * L  # a chunk's partial last piece
            s, k, L, R = s[keep], k[keep], L[keep], R[keep]
            i, e = s // L, s % L
            out = tab[k, f["out_slot"]] + s
        blk, w = e // W, e % W
        row = np.minimum(tab[k, f["start"]] + i, len(rowmeta) - 1)
        live = (i < tab[k, f["count"]]) & (blk < rowmeta[row, 1])
        pa = np.clip(rowmeta[row, 0] + blk, 0, npa_pad - 1)
        seg = np.clip(pa_b2row[pa], 0, last_seg)
        c = np.where(live, b2_cols[seg * W + w], _INT_MAX)
        col[out] = c
        np.add.at(writes, out, 1)
        if not pattern:
            v = t.b2_vals.numpy().reshape(-1)[seg * W + w].astype(np_acc) * t.pa_aval.numpy()[pa].astype(np_acc)
            val[out] = np.where(live & (c != _INT_MAX), v, 0)
    return fp, col, val, writes


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("budget,W", _FETCH_CASES)
def test_fetch_walk_covers_every_slot_once(budget, W, mode):
    """The fetch kernels' walk over a product's chunks (rows past each
    chunk's count included) writes every slot of every chunk exactly once,
    nothing in the gaps between chunks, and gives ``_chunk_fetch``'s
    columns and values bit for bit; a schedule of more than
    ``MAX_LAUNCH_CHUNKS`` chunks splits into launches of at most that many."""
    _, acc = _MODES[mode]
    pattern = mode == "pattern"
    plan, sched = _fetch_plan_of(W, mode, budget)
    assert any(c < R for _, R, _, c in sched)
    fp, col, val, writes = _fetch_walk(plan, sched, W, acc, pattern)
    assert len(fp.launches) == -(-len(sched) // sk.MAX_LAUNCH_CHUNKS)
    assert all(len(x.chunks) <= sk.MAX_LAUNCH_CHUNKS for x in fp.launches)
    assert sorted(i for x in fp.launches for i in x.chunks) == [i for i, (L, R, _, _) in enumerate(sched) if L * R]
    inside = np.zeros(fp.slots, bool)
    for (L, R, st, c), o in zip(sched, fp.slot_off):
        inside[o : o + L * R] = True
        col_p, val_p = sk._chunk_fetch(plan, *sk._chunk_meta(plan.rowmeta, st, c, R, L // W), L=L, R_pad=R, W=W,
                                       accum_dtype=acc, pattern=pattern)
        np.testing.assert_array_equal(col[o : o + L * R].reshape(R, L), col_p.numpy())
        if not pattern:
            assert np.array_equal(val[o : o + L * R].reshape(R, L), val_p.numpy())
    assert np.array_equal(writes[inside], np.ones(int(inside.sum()), np.int64)) and not writes[~inside].any()
    if budget < 1 << 24:
        assert len(fp.launches) > 1


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("budget,W", _FETCH_CASES)
def test_chunk_fetch_all_matches_plain_chunk_by_chunk(budget, W, mode):
    """``chunk_fetch_all`` on CPU tensors: each chunk's (R_pad, L) view
    ``torch.equal`` to ``_chunk_fetch`` (pattern: no values), contiguous, at
    a 16-byte aligned offset of one allocation, one chunk after another;
    ``chunk_fetch`` of one chunk gives the same; no launch is counted."""
    _, acc = _MODES[mode]
    pattern = mode == "pattern"
    plan, sched = _fetch_plan_of(W, mode, budget)
    before = dict(sk.slab_launches)
    got = sk.chunk_fetch_all(plan, sched, W=W, accum_dtype=acc, pattern=pattern)
    fp = sk.fetch_plan(sched, W)
    assert len(got) == len(sched) and sk.slab_launches == before
    base_c = got[0][0].untyped_storage().data_ptr()
    base_v = None if pattern else got[0][1].untyped_storage().data_ptr()
    for (L, R, st, c), o, (col, val) in zip(sched, fp.slot_off, got):
        assert o % sk.FETCH_PIECE == 0
        assert col.shape == (R, L) and col.is_contiguous() and col.data_ptr() == base_c + 4 * o
        assert col.data_ptr() % 16 == 0
        kw = dict(L=L, R_pad=R, W=W, accum_dtype=acc, pattern=pattern)
        col_p, val_p = sk._chunk_fetch(plan, *sk._chunk_meta(plan.rowmeta, st, c, R, L // W), **kw)
        assert torch.equal(col, col_p)
        one = sk.chunk_fetch(plan, st, c, **kw)
        assert torch.equal(one[0], col_p)
        if pattern:
            assert val is None and one[1] is None
        else:
            assert val.dtype == acc and val.is_contiguous() and val.data_ptr() == base_v + acc.itemsize * o
            assert val.data_ptr() % 16 == 0 and torch.equal(val, val_p) and torch.equal(one[1], val_p)


def test_fetch_plan_rounds_each_chunk_to_a_piece():
    """Chunks whose slots are no multiple of 4 (W = 3, an odd row count)
    start at the next piece, so every view is 16-byte aligned; an empty
    chunk takes no slot and no place in a launch."""
    sched = [(9, 3, 0, 3), (6, 0, 3, 0), (12, 5, 3, 4), (3, 1, 8, 1)]
    fp = sk.fetch_plan(sched, 3)
    assert fp.slot_off == (0, 28, 28, 88) and fp.slots == 92
    (x,) = fp.launches
    assert x.chunks == (0, 2, 3) and x.pieces == 7 + 15 + 1
    f = {name: i for i, name in enumerate(sk.FETCH_FIELDS)}
    assert x.table[:, f["piece0"]].tolist() == [0, 7, 22]
    assert x.table[:, f["out_slot"]].tolist() == [0, 28, 88]
    assert x.table[2, [f["start"], f["count"], f["R_pad"], f["L"]]].tolist() == [8, 1, 1, 3]


def test_fetch_plan_refuses_what_the_kernel_does_not_take():
    """A chunk whose L is no multiple of W, whose count lies outside [0,
    R_pad] or whose rows start before the plan's raises ValueError naming
    it, before any allocation or launch; rows past the plan's padding
    raise on the fetch."""
    for bad, match in (((12, 4, 0, 4), "multiple of W"), ((8, 4, 0, 5), "count=5"), ((8, 4, -1, 4), "start")):
        with pytest.raises(ValueError, match=match):
            sk.fetch_plan([(8, 2, 0, 2), bad], 8)
    plan, sched = _fetch_plan_of(8, "pattern", 1 << 24)
    L, R, _, c = sched[0]
    with pytest.raises(ValueError, match="padding"):
        sk.chunk_fetch_all(plan, [(L, R, plan.rowmeta.shape[0] - R + 1, c)], W=8, accum_dtype=torch.float32,
                           pattern=True)


@pytest.mark.parametrize("pattern", [False, True])
def test_cached_plan_moves_and_saves_each_chunk_alone(pattern, tmp_path, monkeypatch):
    """The aligned cache's views of one allocation travel chunk by chunk:
    ``plan.to()`` gives each chunk a storage of its own size, ``save``
    writes each chunk's bytes alone, and the loaded plan's numeric phase
    equals the original's."""
    from spmm_tpu_torch.utils import serialize

    A = _fetch_matrix(pattern)
    plan = ss.spgemm_plan(A, A, slot_budget=1 << 12, device="cpu", pattern=pattern)
    sched, _ = ss._chunk_schedule(plan.classes, plan.class_counts, plan.slot_budget)
    blocks = plan.aligned_cols + plan.aligned_vals
    assert len(blocks) == len(sched) * (1 if pattern else 2)
    assert len({b.untyped_storage().data_ptr() for b in blocks}) == (1 if pattern else 2)
    moved = plan.to("meta")
    for b, m in zip(blocks, moved.aligned_cols + moved.aligned_vals):
        assert m.shape == b.shape and m.untyped_storage().nbytes() == b.numel() * b.element_size()
    sizes = {}
    real = np.savez_compressed
    monkeypatch.setattr(np, "savez_compressed", lambda path, **a: sizes.update(
        {k: v.nbytes for k, v in a.items()}) or real(path, **a))
    serialize.save(tmp_path / "plan.npz", plan)
    for name in ("aligned_cols", "aligned_vals"):
        for i, b in enumerate(getattr(plan, name)):
            assert sizes[f"{name}__{i}"] == b.numel() * b.element_size()
    back = serialize.load(tmp_path / "plan.npz").to("cpu")
    for x, y in zip(ss.spgemm_slab_device(A, A, plan)[0], ss.spgemm_slab_device(A, A, back)[0]):
        assert all(torch.equal(a, b) for a, b in zip(x, y))


def _fetch_matrix(pattern, seed=40):
    A = tsyn.webgraph_like(1500, 9000, seed=seed)
    if pattern:
        return A
    return dataclasses.replace(A, data=np.random.default_rng(seed).standard_normal(A.nnz_pad).astype(np.float32))


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
