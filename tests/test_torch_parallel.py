"""The distributed port (``spmm_tpu_torch.parallel``) on 4 gloo ranks against
the JAX package on a 4-device CPU mesh and against scipy.

Mirrors ``tests/test_parallel.py``: partition round trips (rows, columns),
the all-gather, ring, column-split and SpMV strategies, uneven rows and empty
shards, the SPMD SpGEMM on the fixture matrices and with tail rows, and the
device-resident distributed CSR with its heavy-tail ValueError.  The same
``ShardedCSR`` and B go through the JAX function (in this process, as
``tests/test_parallel.py`` runs it) and through the port's function on the
ranks of ``torch_dist.RankPool`` (one pool for the module).  Stacking the
ranks' blocks must give JAX's ``(n_shards, ...)`` result within 1e-5 of its
max (the same fp32 sums in another order), and scipy's within
``rtol = atol = 1e-4``, as ``tests/test_parallel.py`` checks; A×A's
``indptr`` / ``indices`` must equal scipy's and JAX's.

The hung-rank test tears the pool down and runs last.
"""

import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spmm_tpu.parallel as jpar
from spmm_tpu.formats import containers as jc
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.parallel.partition import unshard_csr_rows as j_unshard_csr_rows

from spmm_tpu_torch import parallel as tpar
from spmm_tpu_torch.formats import containers as tc
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.parallel import mesh as tmesh

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


@pytest.fixture(scope="module")
def mats():
    A = tsyn.webgraph_like(2000, 14000, seed=0)
    Aj = jsyn.webgraph_like(2000, 14000, seed=0)
    B = np.random.default_rng(0).standard_normal((2000, 16)).astype(np.float32)
    return A, Aj, B


def _jax(fn, *args):
    import jax.numpy as jnp

    return np.asarray(fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))


def _close_to_jax(got, ref):
    """Within 1e-5 of max |JAX| (fp32 sums in another order)."""
    assert got.shape == ref.shape
    assert np.abs(got - ref).max(initial=0) <= 1e-5 * max(np.abs(ref).max(initial=0), 1e-30)


def _scipy_square(A):
    ref = (A.to_scipy() @ A.to_scipy()).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    return ref


def _heavy_row(n, rows, seed):
    """``sp.random`` with dense rows ``rows`` (expansion past small classes)."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.01, random_state=seed, format="lil", dtype=np.float32)
    for r in rows:
        A[r, :] = rng.standard_normal(n)
    A = A.tocsr()
    return tc.CSR.from_scipy(A), jc.CSR.from_scipy(A)


# ---------------------------------------------------------------------------
# partitions (host; no ranks)
# ---------------------------------------------------------------------------


def test_partition_rows_roundtrip(mats):
    A, Aj, _ = mats
    S = tpar.partition_rows(A, N)
    assert_same(S, jpar.partition_rows(Aj, N))
    data = np.concatenate([S.data[i][: S.indptr[i][-1]] for i in range(N)])
    idx = np.concatenate([S.indices[i][: S.indptr[i][-1]] for i in range(N)])
    np.testing.assert_array_equal(data, A.data[: A.nnz])
    np.testing.assert_array_equal(idx, A.indices[: A.nnz])
    U = tpar.unshard_csr_rows(S)
    assert_same(U, j_unshard_csr_rows(jpar.partition_rows(Aj, N)))
    assert abs(U.to_scipy() - A.to_scipy()).max() == 0


def test_partition_cols_roundtrip(mats):
    """Column blocks equal JAX's and reassemble to the matrix exactly."""
    A, Aj, _ = mats
    Sc = tpar.partition_cols(A, N)
    assert_same(Sc, jpar.partition_cols(Aj, N))
    m, n = A.shape
    acc = sp.csr_matrix((m, n), dtype=np.float64)
    for i in range(N):
        ptr = np.asarray(Sc.indptr[i], np.int64)[: m + 1]
        k = int(ptr[-1])
        acc = acc + sp.csr_matrix(
            (Sc.data[i][:k].astype(np.float64), Sc.indices[i][:k].astype(np.int64) + int(Sc.col_starts[i]),
             ptr), shape=(m, n))
    d = abs(acc - A.to_scipy())
    assert d.nnz == 0 or d.max() == 0


def test_local_shard_is_tight_and_memoized(mats):
    A, _, _ = mats
    S = tpar.partition_rows(A, N)
    L = tpar.partition.local_shard(S, 2, "cpu")
    assert L is tpar.partition.local_shard(S, 2, "cpu")
    assert L.shape == (S.rows_per_shard, A.shape[1]) and L.nnz == L.nnz_pad == int(S.indptr[2][-1])
    lo = int(S.row_starts[2])
    ref = A.to_scipy()[lo : lo + S.rows_per_shard]
    assert abs(L.to_scipy()[: ref.shape[0]] - ref).max() == 0


# ---------------------------------------------------------------------------
# distributed SpMM strategies
# ---------------------------------------------------------------------------


def _spmm_case(name, A, Aj, B):
    """(port container, JAX container, B as the strategy takes it, JAX fn)."""
    if name == "spmm_dist_colsplit":
        return tpar.partition_cols(A, N), jpar.partition_cols(Aj, N), B
    S, Sj = tpar.partition_rows(A, N), jpar.partition_rows(Aj, N)
    if name == "spmm_dist_ring":
        Bpad = np.zeros((S.rows_per_shard * N, B.shape[1]), np.float32)
        Bpad[: B.shape[0]] = B
        return S, Sj, Bpad
    if name == "spmv_dist":
        return S, Sj, np.ascontiguousarray(B[:, 0])
    return S, Sj, B


@pytest.mark.parametrize("route", ["segment_sum", "ell"])
@pytest.mark.parametrize("name", ["spmm_dist", "spmm_dist_ring", "spmv_dist", "spmm_dist_colsplit"])
def test_spmm_strategies_match_jax_and_scipy(pool, jmesh, mats, name, route):
    """Each strategy's stacked blocks against the JAX function on a 4-device
    mesh and against scipy; ``route="ell"`` sends each rank's local product
    through the ELL pack (K2's plain version), which a repeated call reuses."""
    A, Aj, B = mats
    S, Sj, Bx = _spmm_case(name, A, Aj, B)
    ref_j = _jax(lambda *a: getattr(jpar, name)(Sj, a[0], jmesh), Bx)
    outs = pool.run(td.spmm_task, name, S, Bx, ell=route == "ell")
    got = np.stack([o["block"][0] for o in outs])
    _close_to_jax(got, ref_j)
    for o in outs:
        assert o["packed"] == (1 if route == "ell" else 0) * (N if name == "spmm_dist_ring" else 1)
        np.testing.assert_array_equal(o["again"][0], o["block"][0])
    ref = A.to_scipy() @ B
    if name == "spmv_dist":
        y = tpar.unshard_rows(got[..., None], S)[:, 0]
        np.testing.assert_allclose(y, ref[:, 0], rtol=1e-4, atol=1e-4)
    elif name == "spmm_dist_colsplit":
        np.testing.assert_allclose(got.reshape(-1, B.shape[1])[: A.shape[0]], ref, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(tpar.unshard_rows(got, S), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nrow", [1003, 20])
def test_uneven_rows_and_empty_shards(pool, jmesh, nrow):
    """Rows not divisible by the shards; at 20 rows the last shard is empty
    (its first row is clipped to m)."""
    A = tsyn.random_csr(nrow, 777, 0.01, seed=3)
    Aj = jsyn.random_csr(nrow, 777, 0.01, seed=3)
    S, Sj = tpar.partition_rows(A, N), jpar.partition_rows(Aj, N)
    if nrow == 20:
        assert int(S.indptr[-1][-1]) == 0 and int(S.row_starts[-1]) == nrow
    B = np.random.default_rng(1).standard_normal((777, 8)).astype(np.float32)
    # zero rows past A's columns, to a whole panel per rank
    Bpad = np.zeros((max(S.rows_per_shard * N, -(-777 // N) * N), 8), np.float32)
    Bpad[:777] = B
    ref_j = _jax(lambda b: jpar.spmm_dist(Sj, b, jmesh), Bpad)
    for name in ("spmm_dist", "spmm_dist_ring"):
        got = np.stack([o["block"][0] for o in pool.run(td.spmm_task, name, S, Bpad)])
        _close_to_jax(got, ref_j)
        np.testing.assert_allclose(tpar.unshard_rows(got, S), A.to_scipy() @ B, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# SPMD SpGEMM
# ---------------------------------------------------------------------------


def _spgemm_case(case):
    if case == "fixture":
        return tsyn.webgraph_like(2000, 14000, seed=0), jsyn.webgraph_like(2000, 14000, seed=0), {}
    if case == "values":
        # random values: the value path (pattern detection off)
        A = tsyn.webgraph_like(3000, 21000, seed=11)
        vals = np.random.default_rng(11).standard_normal(A.data.shape).astype(np.float32)
        Aj = jsyn.webgraph_like(3000, 21000, seed=11)
        return (tc.CSR(vals, A.indices, A.indptr, A.shape, A.nnz),
                jc.CSR(vals, Aj.indices, Aj.indptr, Aj.shape, Aj.nnz), {})
    A, Aj = _heavy_row(600, [5], 3)
    return A, Aj, {"classes": (4, 8, 16)}


@pytest.mark.parametrize("case", ["fixture", "values", "tail"])
def test_spgemm_dist_spmd_matches_scipy_and_jax(pool, jmesh, case):
    """Every rank returns the same global CSR; its structure equals scipy's
    and JAX's, its values are within 1e-4.  ``tail``: a dense row above the
    class ceiling goes through the rank's global-sort ESC."""
    A, Aj, kw = _spgemm_case(case)
    S, Sj = tpar.partition_rows(A, N), jpar.partition_rows(Aj, N)
    Cj = jpar.spgemm_dist_spmd(Sj, Aj, jmesh, **kw)
    ref = _scipy_square(A)
    outs = [o["C"] for o in pool.run(td.spgemm_task, S, A, **kw)]
    for C in outs:
        assert C.nnz == ref.nnz == Cj.nnz
        np.testing.assert_array_equal(C.indptr, ref.indptr)
        np.testing.assert_array_equal(C.indptr, np.asarray(Cj.indptr))
        np.testing.assert_array_equal(C.indices[: C.nnz], ref.indices)
        np.testing.assert_array_equal(C.indices[: C.nnz], np.asarray(Cj.indices[: Cj.nnz]))
        np.testing.assert_allclose(C.data[: C.nnz], ref.data, rtol=1e-4, atol=1e-4)
        _close_to_jax(C.data[: C.nnz], np.asarray(Cj.data[: Cj.nnz]))
        assert_same(C, outs[0])


def test_spgemm_dist_spmd_raw_outputs_leave_the_tail_rows(pool, jmesh):
    """``as_csr=False``: each rank's tail rows are JAX's for its shard, and
    its chunk outputs hold exactly the products of the other rows."""
    A, Aj, kw = _spgemm_case("tail")
    S, Sj = tpar.partition_rows(A, N), jpar.partition_rows(Aj, N)
    _, _, tails_j = jpar.spgemm_dist_spmd(Sj, Aj, jmesh, as_csr=False, **kw)
    outs = pool.run(td.spgemm_raw_task, S, A, **kw)
    rows, cols, vals, tail_rows = [], [], [], []
    for s, o in enumerate(outs):
        assert len(o["tails"]) == 1
        np.testing.assert_array_equal(o["tails"][0], np.asarray(tails_j[s]))
        rows.append(o["rows"] + int(S.row_starts[s]))
        cols.append(o["cols"])
        vals.append(o["vals"])
        tail_rows.append(o["tails"][0].astype(np.int64) + int(S.row_starts[s]))
    tail_rows = np.concatenate(tail_rows)
    assert len(tail_rows) > 0
    got = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                        shape=A.shape).tocsr()
    keep = np.ones(A.shape[0])
    keep[tail_rows] = 0
    ref = sp.diags(keep) @ _scipy_square(A)
    ref.eliminate_zeros()
    assert got.nnz == ref.nnz
    assert abs(got - ref).max() <= 1e-4 * abs(ref).max()


def test_spgemm_dist_csr_device_resident(pool, jmesh):
    """C stays row-sharded on each rank's device; the stacked blocks equal
    JAX's per shard and reassemble to scipy's A×A."""
    classes = (16, 64, 256, 1024, 4096, 16384)
    A = tsyn.webgraph_like(2400, 12000, seed=17)
    Aj = jsyn.webgraph_like(2400, 12000, seed=17)
    S, Sj = tpar.partition_rows(A, N), jpar.partition_rows(Aj, N)
    Cj = jpar.spgemm_dist_csr(Sj, Aj, jmesh, classes=classes)
    ref = _scipy_square(A)
    outs = pool.run(td.spgemm_csr_task, S, A, classes=classes)
    assert all(o["tensors"] and o["nnz"] == ref.nnz == Cj.nnz for o in outs)
    blocks = [o["block"] for o in outs]
    G = tpar.ShardedCSR(
        data=np.concatenate([b.data for b in blocks]),
        indices=np.concatenate([b.indices for b in blocks]),
        indptr=np.concatenate([b.indptr for b in blocks]),
        row_starts=blocks[0].row_starts, shape=blocks[0].shape, n_shards=N,
        rows_per_shard=blocks[0].rows_per_shard, nnz=blocks[0].nnz,
    )
    assert G.data.shape == np.asarray(Cj.data).shape
    np.testing.assert_array_equal(G.indptr, np.asarray(Cj.indptr))
    for s in range(N):
        k = int(G.indptr[s, -1])
        np.testing.assert_array_equal(G.indices[s, :k], np.asarray(Cj.indices[s, :k]))
        _close_to_jax(G.data[s, :k], np.asarray(Cj.data[s, :k]))
    U = tpar.unshard_csr_rows(G)
    np.testing.assert_array_equal(U.indptr, ref.indptr)
    np.testing.assert_array_equal(U.indices, ref.indices)
    np.testing.assert_allclose(U.data, ref.data, rtol=1e-4, atol=1e-4)


def test_spgemm_dist_csr_raises_on_heavy_tail_rows(pool, jmesh):
    A, Aj = _heavy_row(600, [5], 3)
    with pytest.raises(ValueError, match="heavy-tail") as ej:
        jpar.spgemm_dist_csr(jpar.partition_rows(Aj, N), Aj, jmesh, classes=(4, 8, 16))
    outs = pool.run(td.spgemm_csr_task, tpar.partition_rows(A, N), A, classes=(4, 8, 16))
    assert all(o["error"] == str(ej.value) for o in outs)


# ---------------------------------------------------------------------------
# the mesh, the bootstrap, the ranks
# ---------------------------------------------------------------------------


def test_mesh_2d_matches_jax_layout(pool):
    """Rank r sits where device r sits in JAX's ``devices.reshape((2, 2))``;
    a gather over one axis collects that axis's line of ranks."""
    jm = jpar.make_mesh((2, 2), ("rows", "cols"))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r, o in enumerate(pool.run(td.mesh_2d_task)):
        row, col = (int(x) for x in np.argwhere(ids == r)[0])
        assert o["coord"] == (row, col)
        assert o["index"] == {"rows": row, "cols": col}
        assert o["size"] == dict(jm.shape)
        assert o["gather_cols"] == ids[row, :].tolist()
        assert o["gather_rows"] == ids[:, col].tolist()


def test_make_mesh_value_errors(pool):
    """The JAX package's two ValueErrors, the same wording; a CUDA mesh on
    gloo and a B on another device than the mesh's raise too."""
    with pytest.raises(ValueError) as too_many:
        jpar.make_mesh(16)
    with pytest.raises(ValueError) as names:
        jpar.make_mesh((2, 2), ("rows",))
    assert str(too_many.value) == "mesh shape (16,) needs 16 devices, have 8"
    for msgs in pool.run(td.make_mesh_errors_task):
        assert msgs[0] == f"mesh shape (8,) needs 8 devices, have {N}"
        assert msgs[1] == str(names.value)
        assert msgs[2] is not None and "nccl" in msgs[2] and "gloo" in msgs[2]
        assert msgs[3] is not None and "meta" in msgs[3]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        tpar.make_mesh(device="cpu")


def test_initialize_distributed_is_a_noop_without_master_addr(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda *a, **k: calls.append(1))
    tmesh.initialize_distributed(device="cpu")
    assert calls == [] and not torch.distributed.is_initialized()


def test_initialize_distributed_retries(monkeypatch):
    """Two failed rendezvous, then success: three calls, gloo, from the
    environment; a group that never comes up raises after ``retries``."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    calls = []

    def flaky(backend, **kw):
        calls.append((backend, kw.get("init_method")))
        if len(calls) <= 2:
            raise RuntimeError("connect refused")

    monkeypatch.setattr(torch.distributed, "init_process_group", flaky)
    tmesh.initialize_distributed(backoff_s=0.0, device="cpu")
    assert calls == [("gloo", "env://")] * 3
    calls.clear()
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: calls.append(1) or (_ for _ in ()).throw(OSError("down")))
    with pytest.raises(RuntimeError, match="after 3 attempts"):
        tmesh.initialize_distributed(retries=3, backoff_s=0.0, device="cpu")
    assert len(calls) == 3


def test_ranks_run_gloo_without_jax(pool):
    for r, e in enumerate(pool.run(td.env_task)):
        assert e == {"rank": r, "world": N, "backend": "gloo", "threads": 1, "jax": False,
                     "spmm_tpu": False}


def test_hung_rank_fails_within_the_timeout(pool):
    """A rank that never joins a collective fails the call within its
    deadline, and the pool is killed; the next call starts a new pool."""
    pool.run(td.env_task)  # a live pool
    procs = list(pool.procs)
    t0 = time.monotonic()
    with pytest.raises(td.RankTimeout, match=r"ranks \[1, 2, 3\] gave no result within 3 s"):
        pool.run(td.hang_task, timeout=3)
    assert time.monotonic() - t0 < 3 + 10
    assert not pool.alive and not any(p.is_alive() for p in procs)
