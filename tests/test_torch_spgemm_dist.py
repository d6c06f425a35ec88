"""The distributed SpGEMM's halo, plan and big-path half
(``spmm_tpu_torch.parallel.spgemm_spmd``) and ``entry.dryrun_multichip`` on 4
gloo ranks, against the JAX package on a 4-device CPU mesh and against scipy.

Mirrors ``tests/test_parallel.py``: ``partition_halo``, the halo product in
pattern and value mode and with tail rows, the runtime halo exchange, plan
reuse with B replicated and row-block sharded, revalue, the streamed big
path (auto pieces under a small ``_MAX_EXP_PAD``, checkpoint and resume,
``b_sharded``, a schedule of tail rows only) and the dryrun.  The same
operands go through the JAX function (in this process) and through the
port's function on the ranks of one ``torch_dist.RankPool`` for the module
(its own, so that ``--dist loadfile`` runs it beside
``test_torch_parallel.py``).  Every rank returns the same global CSR: its
``indptr`` / ``indices`` must equal scipy's and JAX's, its values lie within
``rtol = atol = 1e-4`` of scipy's and within 1e-5 of JAX's max, as
``tests/test_torch_parallel.py`` states.  What the ranks saw
(``torch_dist._watch``) shows which collectives ran and how much of B each
rank's device held.

F1 (ROADMAP queue 3): a plan of all-ones values revalued with other values
must give scipy's product of the new values; the JAX package's
``spgemm_dist_revalue`` keeps the plan's pattern mode there, and the test
documents that it does not.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spmm_tpu.parallel as jpar
import spmm_tpu.parallel.spgemm_spmd as jss
from spmm_tpu.formats import containers as jc
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.ops import slab_spgemm as jslab

from spmm_tpu_torch import parallel as tpar
from spmm_tpu_torch.formats import containers as tc
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.ops import slab_spgemm as tslab
from spmm_tpu_torch.parallel import spgemm_spmd as tss

import torch_dist as td
from torch_parity import assert_same, one_torch_thread  # noqa: F401  (autouse)

N = td.RANKS


@pytest.fixture(scope="module")
def pool():
    p = td.RankPool(N)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh(N)


def _web(n, nnz, seed, values_seed=None):
    """The same webgraph in both packages; seeded normal values when
    ``values_seed`` is given."""
    A, Aj = tsyn.webgraph_like(n, nnz, seed=seed), jsyn.webgraph_like(n, nnz, seed=seed)
    if values_seed is not None:
        v = np.random.default_rng(values_seed).standard_normal(A.data.shape).astype(np.float32)
        A, Aj = dataclasses.replace(A, data=v), dataclasses.replace(Aj, data=v)
    return A, Aj


def _heavy_rows(n, density, rows, seed, width=None):
    """``sp.random`` with dense rows ``rows`` (expansion past small classes),
    dense over the first ``width`` columns (all by default)."""
    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=density, random_state=seed, format="lil", dtype=np.float32)
    w = width or n
    for r in rows:
        M[r, :w] = rng.standard_normal(w)
    M = M.tocsr()
    return tc.CSR.from_scipy(M), jc.CSR.from_scipy(M)


def _scipy_square(A):
    ref = (A.to_scipy() @ A.to_scipy()).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    return ref


def _held(C, ref, Cj=None):
    """Structure equal to scipy's (and JAX's), values within 1e-4 of scipy's
    and 1e-5 of JAX's max."""
    assert C.nnz == ref.nnz
    np.testing.assert_array_equal(np.asarray(C.indptr, np.int64), ref.indptr)
    np.testing.assert_array_equal(C.indices[: C.nnz], ref.indices)
    np.testing.assert_allclose(C.data[: C.nnz], ref.data, rtol=1e-4, atol=1e-4)
    if Cj is not None:
        assert Cj.nnz == C.nnz
        np.testing.assert_array_equal(np.asarray(C.indptr, np.int64), np.asarray(Cj.indptr, np.int64))
        np.testing.assert_array_equal(C.indices[: C.nnz], np.asarray(Cj.indices[: Cj.nnz]))
        dj = np.asarray(Cj.data[: Cj.nnz])
        assert np.abs(C.data[: C.nnz] - dj).max(initial=0) <= 1e-5 * max(np.abs(dj).max(initial=0), 1e-30)


def _held_on_every_rank(outs, ref, Cj=None, key="C"):
    for o in outs:
        _held(o[key], ref, Cj)
        assert_same(o[key], outs[0][key])


def _halo_sizes(A, nblocks):
    """Each of ``nblocks`` row blocks' halo: (rows, nnz)."""
    _, lb_iptr, *_, counts = tss.partition_halo(tpar.partition_rows(A, nblocks), A, structure_only=True)
    return [(int(counts[b]), int(lb_iptr[b, -1])) for b in range(nblocks)]


def _esc_read_the_halo(seen, halo, A, *, smaller=True):
    """The tail rows' global-sort ESC multiplied this rank's halo B (rows
    and nnz), each time on the rank's device, never all of B: with
    ``smaller`` each such halo holds fewer nonzeros than B."""
    assert seen and all(x == (*halo, "cpu") for x in seen)
    assert not smaller or halo[1] < A.nnz


# ---------------------------------------------------------------------------
# the halo on the host (no ranks)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("structure_only", [False, True])
def test_partition_halo_matches_jax(structure_only):
    """The same 6-tuple as JAX's; every shard's halo is smaller than B."""
    A, Aj = _web(2400, 16000, 13)
    got = tss.partition_halo(tpar.partition_rows(A, N), A, structure_only=structure_only)
    want = jss.partition_halo(jpar.partition_rows(Aj, N), Aj, structure_only=structure_only)
    assert_same(got[0], want[0])
    for g, w in zip(got[1:4], want[1:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[4]) == len(want[4]) == N
    for g, w in zip(got[4], want[4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[5], want[5])
    assert got[5].max() < A.nrow


def test_per_shard_sizing_against_each_halo_matches_jax():
    """Sizing each shard against its own halo B gives JAX's classes, counts,
    pair maximum and nnz, and the same classes as sizing against all of B
    (a row's class depends only on the lengths of the B rows it reads)."""
    A, Aj = _web(2400, 16000, 13)
    S, Sj = tpar.partition_rows(A, N), jpar.partition_rows(Aj, N)
    classes = tslab._norm_classes(tslab.DEFAULT_CLASSES, 8)
    A_rel, lb_iptr, *_ = tss.partition_halo(S, A, structure_only=True)
    Aj_rel, lbj_iptr, *_ = jss.partition_halo(Sj, Aj, structure_only=True)
    got = tss._per_shard_sizing(A_rel, None, 8, classes, b_iptr_per_shard=lb_iptr)
    want = jss._per_shard_sizing(Aj_rel, Aj, 8, classes, b_iptr_per_shard=lbj_iptr)
    for g, w in zip(got[:4], want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    whole = tss._per_shard_sizing(S, A, 8, classes)
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_exchange_maps_deliver_each_halo_in_order():
    """Replaying the exchange on the host: each owner's block is
    ``partition_rows``' block, and what each requester receives, owner by
    owner, is its halo CSR's column ids and values in order, with exact
    split sizes (the pair sizes add up to each halo's nnz)."""
    A, _ = _web(2400, 16000, 19, values_seed=19)
    S = tpar.partition_rows(A, N)
    _, lb_iptr, lb_ind, lb_dat, rows, _ = tss.partition_halo(S, A)
    b_part = tpar.partition_rows(A, N)
    rb = tpar.partition.rows_per_shard(A.nrow, N)
    assert rb == b_part.rows_per_shard
    blocks, sends, pair = [], [], None
    for t in range(N):
        blocks.append(tss._row_block(A, N, t, "cpu"))
        assert_same(blocks[t], tpar.partition.local_shard(b_part, t, "cpu"))
        send, pair_t = tss._exchange_maps(rows, np.asarray(A.indptr, np.int64), rb, t)
        assert pair is None or np.array_equal(pair, pair_t)
        pair = pair_t
        assert send.dtype == np.int32 and len(send) == pair[:, t].sum()
        for s, lo in enumerate(np.cumsum(pair[:, t]) - pair[:, t]):  # element order per requester
            assert (np.diff(send[lo : lo + pair[s, t]]) > 0).all()
        assert len(send) == 0 or 0 <= send.min() and send.max() < blocks[t].nnz
        sends.append(send)  # the order they travel in
    np.testing.assert_array_equal(pair.sum(axis=1), lb_iptr[:, -1])
    for s in range(N):
        ind, dat = [], []
        for t in range(N):
            lo = pair[:s, t].sum()
            idx = sends[t][lo : lo + pair[s, t]]
            ind.append(blocks[t].indices.numpy()[idx])
            dat.append(blocks[t].data.numpy()[idx])
        k = int(lb_iptr[s, -1])
        np.testing.assert_array_equal(np.concatenate(ind), lb_ind[s, :k])
        np.testing.assert_array_equal(np.concatenate(dat), lb_dat[s, :k])


def test_exports_match_jax():
    """``spmm_tpu_torch.parallel`` exports the JAX package's names, in its
    order; ``entry`` has ``dryrun_multichip``."""
    from spmm_tpu_torch import entry

    assert tpar.__all__ == jpar.__all__
    assert all(callable(getattr(tpar, n)) for n in tpar.__all__)
    assert callable(entry.dryrun_multichip)


def test_checkpoint_reader_never_writes(tmp_path):
    """A reader of the distributed big path's checkpoint (every rank but
    rank 0) raises without a manifest, leaves a torn piece to the writer,
    and writes nothing; the writer drops the torn piece."""
    A = tsyn.random_csr(64, 64, 0.1, seed=0)
    args = (str(tmp_path), A, A, 2, (8,), 8, 1 << 14, "float32", False)
    with pytest.raises(ValueError, match="every process sees"):
        tslab._BigCheckpoint(*args, writer=False)
    assert not os.listdir(tmp_path)
    tslab._BigCheckpoint(*args, extra={"dist_nsh": 4})
    reader = tslab._BigCheckpoint(*args, extra={"dist_nsh": 4}, writer=False)
    with pytest.raises(ValueError, match="manifest mismatch"):
        tslab._BigCheckpoint(*args, extra={"dist_nsh": 2}, writer=False)
    torn = tmp_path / "piece_00000.npz"
    torn.write_bytes(b"torn")
    assert reader.load_multi(0, 4) is None and torn.exists()
    writer = tslab._BigCheckpoint(*args, extra={"dist_nsh": 4})
    assert writer.load_multi(0, 4) is None and not torn.exists()


# ---------------------------------------------------------------------------
# the halo products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("values", ["pattern", "random"])
def test_spgemm_dist_halo_matches_scipy_and_jax(pool, jmesh, values):
    """Each rank's tables read only its halo: fewer rows and nonzeros than
    B, the halo's own."""
    A, Aj = _web(2400, 16000, 13, values_seed=13 if values == "random" else None)
    Cj = jss.spgemm_dist_halo(jpar.partition_rows(Aj, N), Aj, jmesh)
    S = tpar.partition_rows(A, N)
    outs = pool.run(td.halo_task, "spgemm_dist_halo", S, A)
    _held_on_every_rank(outs, _scipy_square(A), Cj)
    _, lb_iptr, *_ , counts = tss.partition_halo(S, A, structure_only=True)
    for s, o in enumerate(outs):
        assert o["a2a"] == []
        assert o["b"] == [(int(counts[s]), int(lb_iptr[s, -1]), "cpu")]
        assert lb_iptr[s, -1] < A.nnz


@pytest.mark.parametrize("width", [None, 400])
def test_spgemm_dist_halo_tail_rows(pool, jmesh, width):
    """Rows above the class ceiling (the two dense rows and the rows that
    read them), on every shard, go through the global-sort ESC, the
    relabeled shard against its own halo B.  With the dense rows over half
    the columns, every halo is smaller than B."""
    A, Aj = _heavy_rows(800, 0.008, [3, 798], 7, width)
    kw = {"classes": (4, 8, 16, 32)}
    Cj = jss.spgemm_dist_halo(jpar.partition_rows(Aj, N), Aj, jmesh, **kw)
    S = tpar.partition_rows(A, N)
    sh_counts = tss._per_shard_sizing(S, A, 8, tslab._norm_classes(kw["classes"], 8))[1]
    assert (sh_counts[:, -1] > 0).all()
    outs = pool.run(td.halo_task, "spgemm_dist_halo", S, A, **kw)
    _held_on_every_rank(outs, _scipy_square(A), Cj)
    for o, halo in zip(outs, _halo_sizes(A, N)):
        _esc_read_the_halo(o["sorted"], halo, A, smaller=width is not None)


@pytest.mark.parametrize("values", ["pattern", "random"])
def test_spgemm_dist_halo_exchange_matches_scipy_and_jax(pool, jmesh, values):
    """B row-block sharded: each rank holds its own block and receives its
    halo by ``all_to_all_single`` (int32 column ids only in pattern mode);
    no rank's tables see a full replica of B."""
    A, Aj = _web(2400, 16000, 19, values_seed=19 if values == "random" else None)
    Cj = jss.spgemm_dist_halo_exchange(jpar.partition_rows(Aj, N), Aj, jmesh)
    S = tpar.partition_rows(A, N)
    outs = pool.run(td.halo_task, "spgemm_dist_halo_exchange", S, A)
    _held_on_every_rank(outs, _scipy_square(A), Cj)
    _, lb_iptr, *_, counts = tss.partition_halo(S, A, structure_only=True)
    b_part = tpar.partition_rows(A, N)
    for s, o in enumerate(outs):
        assert o["a2a"] == (["int32"] if values == "pattern" else ["int32", "float32"])
        assert o["b"] == [(int(counts[s]), int(lb_iptr[s, -1]), "cpu")]
        assert o["block"] == [int(b_part.indptr[s][-1])]
        assert lb_iptr[s, -1] < A.nnz and o["block"][0] < A.nnz


@pytest.mark.parametrize("width", [None, 400])
def test_spgemm_dist_halo_exchange_tail_rows(pool, jmesh, width):
    """Tail rows of an exchanged halo: the relabeled shard against the
    exchanged halo itself through the global-sort ESC, so no rank's device
    holds more of B than its block and its halo (with the dense rows over
    half the columns, every halo is smaller than B)."""
    A, Aj = _heavy_rows(800, 0.008, [3, 798], 7, width)
    kw = {"classes": (4, 8, 16, 32)}
    Cj = jss.spgemm_dist_halo_exchange(jpar.partition_rows(Aj, N), Aj, jmesh, **kw)
    outs = pool.run(td.halo_task, "spgemm_dist_halo_exchange", tpar.partition_rows(A, N), A, **kw)
    _held_on_every_rank(outs, _scipy_square(A), Cj)
    for o, halo in zip(outs, _halo_sizes(A, N)):
        _esc_read_the_halo(o["sorted"], halo, A, smaller=width is not None)


# ---------------------------------------------------------------------------
# plan / exec / revalue
# ---------------------------------------------------------------------------

PLAN_KW = {"classes": (16, 64, 256), "slot_budget": 1 << 14}


@pytest.mark.parametrize("b_sharded", [False, True])
@pytest.mark.parametrize("values", ["pattern", "random"])
def test_spgemm_dist_plan_exec(pool, jmesh, values, b_sharded):
    """Plan once, execute twice: both products equal scipy's and JAX's.  The
    exec runs no ``all_to_all_single`` and builds no tables; with
    ``b_sharded`` the plan exchanges the halo (once) and its tables hold the
    halo only, else B whole."""
    seed = 21 if b_sharded else 11
    A, Aj = _web(1024, 6100, seed, values_seed=seed + 1 if values == "random" else None)
    Sj = jpar.partition_rows(Aj, N)
    Cj = jss.spgemm_dist_exec(jss.spgemm_dist_plan(Sj, Aj, jmesh, b_sharded=b_sharded, **PLAN_KW), jmesh)
    S = tpar.partition_rows(A, N)
    outs = pool.run(td.plan_task, S, A, b_sharded=b_sharded, **PLAN_KW)
    ref = _scipy_square(A)
    _, lb_iptr, *_, counts = tss.partition_halo(S, A, structure_only=True)
    for s, o in enumerate(outs):
        for C in o["C"]:
            _held(C, ref, Cj)
        assert o["pattern"] == (values == "pattern") and o["devices"] == ["cpu"]
        assert o["exec"] == {"a2a": [], "b": [], "sorted": [], "block": [], "pieces": 0}
        if b_sharded:
            assert o["plan"]["a2a"] == (["int32"] if values == "pattern" else ["int32", "float32"])
            assert o["plan"]["b"] == [(int(counts[s]), int(lb_iptr[s, -1]), "cpu")]
            assert o["plan"]["block"][0] < A.nnz and lb_iptr[s, -1] < A.nnz
        else:
            assert o["plan"]["a2a"] == [] and o["plan"]["b"] == [(A.nrow, A.nnz, "cpu")]


def test_spgemm_dist_exec_raw_outputs(pool, jmesh):
    """``as_csr=False``: each rank's chunk outputs carry a leading axis of
    1 on JAX's schedule, and with the plan's tail rows' products they hold
    exactly scipy's A×A (tail rows: a dense row past the class ceiling)."""
    A, Aj = _heavy_rows(600, 0.01, [5], 3)
    kw = {"classes": (4, 8, 16), "slot_budget": 1 << 14}
    plan_j = jss.spgemm_dist_plan(jpar.partition_rows(Aj, N), Aj, jmesh, **kw)
    S = tpar.partition_rows(A, N)
    outs = pool.run(td.exec_raw_task, S, A, **kw)
    rows, cols, vals = [], [], []
    for s, o in enumerate(outs):
        assert o["lead"] == [1] and tuple(o["schedule"]) == tuple(plan_j.schedule)
        parts = [(o["rows"], o["cols"], o["vals"])] + ([o["tail"]] if o["tail"] is not None else [])
        for r, c, v in parts:
            rows.append(np.asarray(r, np.int64) + int(S.row_starts[s]))
            cols.append(np.asarray(c, np.int64))
            vals.append(np.asarray(v))
    assert any(o["tail"] is not None for o in outs)
    got = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                        shape=A.shape).tocsr()
    ref = _scipy_square(A)
    assert got.nnz == ref.nnz and abs(got - ref).max() <= 1e-4 * abs(ref).max()


@pytest.mark.parametrize("b_sharded", [False, True])
def test_spgemm_dist_revalue(pool, jmesh, b_sharded):
    """New values on the same structure: the product equals scipy's and
    JAX's on the new values; with ``b_sharded`` only B's values travel (one
    float32 exchange); another structure raises JAX's ValueError."""
    A, Aj = _web(1024, 6100, 51, values_seed=52)
    A2, Aj2 = _web(1024, 6100, 51, values_seed=53)
    bad, badj = _web(1024, 6000, 53)
    plan_j = jss.spgemm_dist_plan(jpar.partition_rows(Aj, N), Aj, jmesh, b_sharded=b_sharded, **PLAN_KW)
    Cj = jss.spgemm_dist_exec(jss.spgemm_dist_revalue(plan_j, jpar.partition_rows(Aj2, N), Aj2, jmesh), jmesh)
    with pytest.raises(ValueError) as ej:
        jss.spgemm_dist_revalue(plan_j, jpar.partition_rows(badj, N), badj, jmesh)
    outs = pool.run(td.revalue_task, tpar.partition_rows(A, N), A, tpar.partition_rows(A2, N), A2,
                    (tpar.partition_rows(bad, N), bad), b_sharded=b_sharded, **PLAN_KW)
    _held_on_every_rank(outs, _scipy_square(A2), Cj)
    for o in outs:
        assert o["patterns"] == (False, False)
        assert o["revalue"]["a2a"] == (["float32"] if b_sharded else [])
        assert o["error"] == str(ej.value)


def test_spgemm_dist_plan_b_sharded_tail_rows(pool, jmesh):
    """A ``b_sharded`` plan with tail rows on every shard, revalued: the
    product of the new values equals scipy's and JAX's, and at plan time and
    at revalue the tail rows' ESC multiplied the rank's exchanged halo, each
    smaller than B, never a replica of B."""
    A, Aj = _heavy_rows(800, 0.008, [3, 798], 7, 400)
    v2 = np.random.default_rng(8).standard_normal(A.data.shape).astype(np.float32)
    A2, Aj2 = dataclasses.replace(A, data=v2), dataclasses.replace(Aj, data=v2)
    kw = {"classes": (4, 8, 16, 32), "slot_budget": 1 << 14}
    plan_j = jss.spgemm_dist_plan(jpar.partition_rows(Aj, N), Aj, jmesh, b_sharded=True, **kw)
    Cj = jss.spgemm_dist_exec(jss.spgemm_dist_revalue(plan_j, jpar.partition_rows(Aj2, N), Aj2, jmesh), jmesh)
    S = tpar.partition_rows(A, N)
    outs = pool.run(td.revalue_task, S, A, tpar.partition_rows(A2, N), A2, (S, A), b_sharded=True, **kw)
    _held_on_every_rank(outs, _scipy_square(A2), Cj)
    for o, halo in zip(outs, _halo_sizes(A, N)):
        assert o["patterns"] == (False, False) and o["error"] is None
        _esc_read_the_halo(o["plan"]["sorted"], halo, A)
        _esc_read_the_halo(o["revalue"]["sorted"], halo, A)


@pytest.mark.parametrize("b_sharded", [False, True])
def test_spgemm_dist_revalue_of_an_all_ones_plan_f1(pool, jmesh, b_sharded):
    """F1: a plan of all-ones values (pattern mode) revalued with normal
    values gains its value channels and gives scipy's product of the new
    values.  The JAX package keeps the plan's pattern mode: its product
    holds the counts, not the new values."""
    A, Aj = _web(1024, 6100, 61)
    A2, Aj2 = _web(1024, 6100, 61, values_seed=62)
    ref = _scipy_square(A2)
    plan_j = jss.spgemm_dist_plan(jpar.partition_rows(Aj, N), Aj, jmesh, b_sharded=b_sharded, **PLAN_KW)
    Cj = jss.spgemm_dist_exec(jss.spgemm_dist_revalue(plan_j, jpar.partition_rows(Aj2, N), Aj2, jmesh), jmesh)
    assert not np.allclose(np.asarray(Cj.data[: Cj.nnz]), ref.data, rtol=1e-4, atol=1e-4)
    outs = pool.run(td.revalue_task, tpar.partition_rows(A, N), A, tpar.partition_rows(A2, N), A2,
                    (tpar.partition_rows(A, N), A), b_sharded=b_sharded, **PLAN_KW)
    _held_on_every_rank(outs, ref)
    for o in outs:
        assert o["patterns"] == (True, False) and o["error"] is None


# ---------------------------------------------------------------------------
# the streamed big path
# ---------------------------------------------------------------------------


def test_spgemm_dist_big_pieces_and_checkpoint(pool, jmesh, tmp_path, monkeypatch):
    """A small ``_MAX_EXP_PAD`` (set on every rank) forces many pieces per
    rank; the product equals scipy's and JAX's.  Checkpointed with 2 pieces:
    one file per piece; with one deleted, the resume computes that piece
    alone; other operands in the same directory raise on every rank."""
    A, Aj = _web(4096, 26000, 31)
    ref = _scipy_square(A)
    monkeypatch.setattr(jslab, "_MAX_EXP_PAD", 1 << 13)
    Cj = jss.spgemm_dist_big(Aj, Aj, jmesh)
    outs = pool.run(td.big_task, A, A, max_exp_pad=1 << 13)
    _held_on_every_rank(outs, ref, Cj)
    assert all(o["pieces"] > 2 for o in outs)

    d = str(tmp_path / "ck")
    outs = pool.run(td.big_task, A, A, pieces=2, checkpoint_dir=d)
    _held_on_every_rank(outs, ref)
    assert all(o["pieces"] == 2 for o in outs)
    files = sorted(glob.glob(os.path.join(d, "piece_*.npz")))
    assert len(files) == 2
    os.remove(files[0])
    outs = pool.run(td.big_task, A, A, pieces=2, checkpoint_dir=d)
    _held_on_every_rank(outs, ref)
    assert [o["pieces"] for o in outs] == [1] * N
    A2, _ = _web(4096, 26000, 32)
    outs = pool.run(td.big_task, A2, A2, pieces=2, checkpoint_dir=d)
    assert all("manifest mismatch" in o["error"] for o in outs)


@pytest.mark.parametrize("values", ["pattern", "random"])
def test_spgemm_dist_big_b_sharded(pool, jmesh, values):
    """Every piece's halo fetched by ``all_to_all_single``: the product equals
    scipy's and JAX's, and no rank's tables see a full replica of B."""
    A, Aj = _web(4096, 26000, 71, values_seed=72 if values == "random" else None)
    Cj = jss.spgemm_dist_big(Aj, Aj, jmesh, pieces=2, b_sharded=True)
    outs = pool.run(td.big_task, A, A, pieces=2, b_sharded=True)
    _held_on_every_rank(outs, _scipy_square(A), Cj)
    for o in outs:
        assert len(o["a2a"]) == (2 if values == "pattern" else 4)
        assert len(o["b"]) == 2 and all(nnz < A.nnz for _, nnz, _ in o["b"])


@pytest.mark.parametrize("b_sharded", [False, True])
def test_spgemm_dist_big_all_tail(pool, jmesh, b_sharded):
    """Every row past the class ceiling: no chunk at all, the whole product
    through the global-sort ESC.  It multiplies each piece by that piece's
    exchanged halo with ``b_sharded``, each smaller than B, and by B whole
    without."""
    A, Aj = _web(1024, 8000, 81)
    kw = {"pieces": 2, "classes": (8, 16), "slot_budget": 1 << 12}
    Cj = jss.spgemm_dist_big(Aj, Aj, jmesh, **kw)
    outs = pool.run(td.big_task, A, A, b_sharded=b_sharded, **kw)
    _held_on_every_rank(outs, _scipy_square(A), Cj)
    halos = _halo_sizes(A, 2 * N)
    for s, o in enumerate(outs):
        if b_sharded:
            assert o["sorted"] == [(*halos[2 * s + p], "cpu") for p in range(2)]
            assert all(nnz < A.nnz for _, nnz in halos[2 * s : 2 * s + 2])
        else:
            assert o["sorted"] == [(A.nrow, A.nnz, "cpu")] * 2


def test_spgemm_dist_moderate_scale(pool):
    """Moderate-scale parity (a slow test in the JAX package, ~5 s on the
    ranks here): a power-law product of >= 1M output nonzeros through the
    device-resident strategy and the runtime halo exchange, exact against
    scipy."""
    A = tsyn.webgraph_like(30000, 210000, seed=41)
    ref = _scipy_square(A)
    assert ref.nnz >= 1_000_000
    S = tpar.partition_rows(A, N)
    blocks = [o["block"] for o in pool.run(td.spgemm_csr_task, S, A, timeout=600)]
    G = dataclasses.replace(blocks[0], data=np.concatenate([b.data for b in blocks]),
                            indices=np.concatenate([b.indices for b in blocks]),
                            indptr=np.concatenate([b.indptr for b in blocks]))
    _held(tpar.unshard_csr_rows(G), ref)
    outs = pool.run(td.halo_task, "spgemm_dist_halo_exchange", S, A, timeout=600)
    _held_on_every_rank(outs, ref)


def test_new_entry_points_with_an_empty_shard(pool):
    """20 rows over 4 ranks: the last shard holds no row, so its halo is
    empty and it sends and receives nothing; every entry point still gives
    scipy's product."""
    A = tsyn.random_csr(20, 20, 0.3, seed=5)
    S = tpar.partition_rows(A, N)
    assert int(S.indptr[-1][-1]) == 0
    ref = _scipy_square(A)
    for name in ("spgemm_dist_halo", "spgemm_dist_halo_exchange"):
        _held_on_every_rank(pool.run(td.halo_task, name, S, A), ref)
    for o in pool.run(td.plan_task, S, A, b_sharded=True):
        for C in o["C"]:
            _held(C, ref)
    _held_on_every_rank(pool.run(td.big_task, A, A, pieces=2, b_sharded=True), ref)


# ---------------------------------------------------------------------------
# refusals, the dryrun
# ---------------------------------------------------------------------------


def test_new_entry_points_refuse_a_b_off_the_mesh(pool):
    """A B held in tensors on another device type than the mesh's raises
    (no silent copy)."""
    A = tsyn.random_csr(64, 64, 0.1, seed=0)
    B_meta = tc.CSR(data=torch.empty(A.nnz, device="meta"),
                    indices=torch.empty(A.nnz, dtype=torch.int32, device="meta"),
                    indptr=torch.empty(65, dtype=torch.int64, device="meta"), shape=A.shape, nnz=A.nnz)
    for msgs in pool.run(td.b_off_the_mesh_task, tpar.partition_rows(A, N), A, B_meta):
        assert len(msgs) == 4 and all(m is not None and "lies on meta" in m for m in msgs)


def test_dryrun_multichip_on_four_ranks(pool):
    """``dryrun_multichip(4)`` on a (2, 2) mesh: rank 0 prints the JAX
    package's ten ``dryrun ... OK`` lines (every check inside holds against
    scipy), the others print nothing; the ring's products take the ELL route
    (K2's) when asked; no rank loads JAX."""
    outs = pool.run(td.dryrun_task, 4, ell=True, timeout=120)
    lines = outs[0]["out"].splitlines()
    heads = ["dryrun_multichip OK: mesh={'rows': 2, 'cols': 2}", "dryrun spgemm_dist_spmd OK",
             "dryrun spgemm_dist_csr OK", "dryrun spgemm_dist_halo_exchange OK",
             "dryrun spgemm_dist_plan/exec OK", "dryrun spgemm_dist_plan(b_sharded)/exec OK",
             "dryrun spgemm_dist_revalue OK", "dryrun spgemm_dist_big OK",
             "dryrun spgemm_dist_big(b_sharded) OK", "dryrun spmm_dist_colsplit OK"]
    assert len(lines) == len(heads) and all(ln.startswith(h) for ln, h in zip(lines, heads))
    assert all(o["out"] == "" for o in outs[1:])
    # two rings of 2 steps, then the column-split product
    assert all(o["ell_products"] == 5 and not o["jax"] for o in outs)


def test_dryrun_multichip_refuses_another_world_size(pool):
    outs = pool.run(td.dryrun_error_task, 8)
    assert all("world size 8 (have 4)" in m for m in outs)
