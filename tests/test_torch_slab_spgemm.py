"""The port's slab-sorted SpGEMM (``spmm_tpu_torch/ops/slab_spgemm.py``) against
scipy and the JAX package's ``spmm_tpu/ops/slab_spgemm.py``.

The first twenty functions mirror ``tests/test_spgemm_slab.py`` case for case
on the CPU.  Tolerance as there: ``indptr``/``indices`` equal, data within
rtol/atol 2e-5 (the merge's prefix-sum difference loses about 1 ulp per run
against scipy's direct sums); pattern counts are exact.  The parity tests feed
both packages the same seeded matrices and compare the sizing, the plan's
class order and every chunk's output.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.ops import slab_spgemm as js

from spmm_tpu_torch import ops
from spmm_tpu_torch.formats import CSR
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.ops import slab_spgemm as ss
from spmm_tpu_torch.ops.slab_spgemm import spgemm_plan, spgemm_slab

from torch_parity import SIZING_CASES, assert_same, one_torch_thread, sizing_case  # noqa: F401  (autouse)


def _oracle(A, B):
    C = (A @ B).tocsr()
    C.sum_duplicates()
    C.sort_indices()
    return C


def _check(C, Cs):
    assert np.array_equal(np.asarray(C.indptr, np.int64), Cs.indptr.astype(np.int64))
    assert np.array_equal(np.asarray(C.indices[: C.nnz]), Cs.indices)
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), Cs.data, rtol=2e-5, atol=2e-5)


def _with_values(A, seed):
    rng = np.random.default_rng(seed)
    return dataclasses.replace(A, data=rng.standard_normal(np.asarray(A.data).shape).astype(np.float32))


def _assert_chunks_equal(o1, o2):
    for c1, c2 in zip(o1, o2, strict=True):
        for x1, x2 in zip(c1, c2, strict=True):
            assert torch.equal(x1, x2)


# ---- mirrors of tests/test_spgemm_slab.py -----------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_rectangular(seed):
    rng = np.random.default_rng(seed)
    m, n, k = (int(x) for x in rng.integers(5, 250, 3))
    A = sp.random(m, n, density=0.05, random_state=seed, format="csr", dtype=np.float32)
    B = sp.random(n, k, density=0.05, random_state=seed + 99, format="csr", dtype=np.float32)
    C = spgemm_slab(CSR.from_scipy(A), CSR.from_scipy(B), classes=(4, 16, 64), slot_budget=1 << 14,
                    device="cpu")
    _check(C, _oracle(A, B))


@pytest.mark.parametrize("seg_w", [1, 4, 8])
@pytest.mark.parametrize("values", ["pattern", "random"])
def test_webgraph_axa_seg_widths(seg_w, values):
    A = tsyn.webgraph_like(2000, 12000, seed=3)
    if values == "random":
        A = _with_values(A, 31)
    C = spgemm_slab(A, A, seg_w=seg_w, device="cpu")
    _check(C, _oracle(A.to_scipy(), A.to_scipy()))


def test_tail_fallback():
    """A row above the largest class goes through the global-sort ESC and
    merges seamlessly."""
    rng = np.random.default_rng(7)
    n = 400
    A = sp.random(n, n, density=0.02, random_state=7, format="lil", dtype=np.float32)
    A[0, :] = rng.standard_normal(n)  # heavy row: expansion ~ nnz(A)
    A = A.tocsr()
    C = spgemm_slab(CSR.from_scipy(A), CSR.from_scipy(A), classes=(4, 8), slot_budget=1 << 12,
                    device="cpu")
    _check(C, _oracle(A, A))


def test_empty_and_zero_rows():
    A = sp.csr_matrix((5, 7), dtype=np.float32)
    B = sp.random(7, 3, density=0.3, random_state=0, format="csr", dtype=np.float32)
    C = spgemm_slab(CSR.from_scipy(A), CSR.from_scipy(B), device="cpu")
    assert C.nnz == 0 and C.shape == (5, 3)
    C2 = spgemm_slab(CSR.from_scipy(B), CSR.from_scipy(A.T.tocsr()), device="cpu")
    assert C2.nnz == 0 and C2.shape == (7, 5)


def test_duplicate_merge_values():
    A = sp.csr_matrix(np.array([[1.0, 2.0, 0.0], [0.0, 1.0, 1.0]], np.float32))
    B = sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 0.0], [0.5, 0.5]], np.float32))
    C = spgemm_slab(CSR.from_scipy(A), CSR.from_scipy(B), device="cpu")
    _check(C, _oracle(A, B))


def test_plan_metadata():
    A = tsyn.webgraph_like(500, 3000, seed=4)
    plan = spgemm_plan(A, A, seg_w=4, device="cpu")
    assert plan.nrow == 500
    assert sum(plan.class_counts) <= 500
    lenB = np.diff(np.asarray(A.indptr))
    assert plan.npa * plan.seg_w >= lenB[np.asarray(A.indices[: A.nnz])].sum()


def test_matches_global_sort_path():
    A = tsyn.webgraph_like(800, 4800, seed=5)
    C1 = spgemm_slab(A, A, device="cpu")
    C2 = ops.spgemm_sorted(A, A, device="cpu")
    assert np.array_equal(np.asarray(C1.indices[: C1.nnz]), np.asarray(C2.indices[: C2.nnz]))
    np.testing.assert_allclose(np.asarray(C1.data[: C1.nnz]), np.asarray(C2.data[: C2.nnz]), rtol=1e-5)


def test_prebuilt_plan_uses_its_own_budget():
    """A plan built with a small slot budget runs with that budget, not the
    default: a larger one would schedule chunks past its rows_sorted padding."""
    A = tsyn.webgraph_like(3000, 18000, seed=6)
    plan = spgemm_plan(A, A, slot_budget=1 << 14, device="cpu")
    outs, tails, _ = ss.spgemm_slab_device(A, A, plan=plan)  # default budget differs
    nnz_out = sum(int(o[3].sum()) for o in outs)
    ref = _oracle(A.to_scipy(), A.to_scipy())
    assert nnz_out == ref.nnz - sum(ref.indptr[r + 1] - ref.indptr[r] for r in np.asarray(tails, np.int64))


def test_spgemm_slab_csr_device_chainable():
    """The CSR held in tensors chains into SpMM without host transfers."""
    A = tsyn.webgraph_like(1200, 7200, seed=8)
    C = ss.spgemm_slab_csr(A, A, device="cpu")
    assert isinstance(C.data, torch.Tensor)
    ref = _oracle(A.to_scipy(), A.to_scipy())
    assert C.nnz == ref.nnz
    Ch = C.host()
    np.testing.assert_array_equal(np.asarray(Ch.indptr, np.int64), ref.indptr)
    np.testing.assert_array_equal(Ch.indices[: C.nnz], ref.indices)
    np.testing.assert_allclose(Ch.data[: C.nnz], ref.data, rtol=1e-4, atol=1e-4)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1200, 4)).astype(np.float32))
    y = ops.spmm_xla(C, x).numpy()
    np.testing.assert_allclose(y, ref @ x.numpy(), rtol=2e-4, atol=2e-4)


def test_spgemm_chain_no_host_roundtrip(monkeypatch):
    """Chaining C = A@A into C@C keeps sizing on the device: no ``.host()``
    of the chained operand."""
    A = tsyn.webgraph_like(900, 5400, seed=5)
    C = ss.spgemm_slab_csr(A, A, device="cpu")
    pulled = []
    orig_host = CSR.host
    monkeypatch.setattr(CSR, "host", lambda self: pulled.append(self) or orig_host(self))
    D = ss.spgemm_slab_csr(C, C.to("cpu"))
    assert not pulled, "chained spgemm pulled a device CSR to host"
    Cs = _oracle(A.to_scipy(), A.to_scipy())
    ref = _oracle(Cs, Cs)
    assert D.nnz == ref.nnz
    Dh = orig_host(D)
    np.testing.assert_array_equal(np.asarray(Dh.indptr, np.int64), ref.indptr)
    np.testing.assert_array_equal(Dh.indices[: D.nnz], ref.indices)
    np.testing.assert_allclose(Dh.data[: D.nnz], ref.data, rtol=2e-4, atol=2e-4)


def _jax_csr(M):
    """The JAX package's CSR over the same host arrays as the port's ``M``."""
    from spmm_tpu.formats import CSR as JCSR

    return JCSR(data=np.asarray(M.data), indices=np.asarray(M.indices), indptr=np.asarray(M.indptr),
                shape=M.shape, nnz=M.nnz)


@pytest.mark.parametrize("held", ["numpy", "tensors"])
@pytest.mark.parametrize("case", SIZING_CASES)
def test_sizing_matches_jax_on_every_case(case, held, monkeypatch):
    """``_sizing`` on the CPU (host operands copied there, or operands held
    in tensors) gives the JAX package's npa, nsegB, folded classes, counts
    and class order on the same inputs, and raises where it should:
    ``_ExpansionTooLarge`` over a cut budget, with args (padded slots, body
    slots: the piece hint reads the second) equal to the JAX sizing's npa·W
    and (npa - tail pairs)·W with the budget uncut; ValueError for a column
    of A that is not a row of B."""
    A, B, W, classes, max_exp, raises = sizing_case(case)
    if max_exp is not None:
        monkeypatch.setattr(ss, "_MAX_EXP_PAD", max_exp)
    Ad = A if held == "numpy" else A.to("cpu")
    Bd = Ad if B is A else B if held == "numpy" else B.to("cpu")
    if raises is not None:
        with pytest.raises(raises) as got:
            ss._sizing(Ad, Bd, W, classes, "cpu")
        assert type(got.value) is raises
        if case == "overflow":  # the tail row's pairs are not body slots
            sj = js._sizing(_jax_csr(A), _jax_csr(B), W, classes)
            segs = (np.diff(np.asarray(B.indptr, np.int64)) + W - 1) // W
            row_pairs = sp.csr_matrix((segs[np.asarray(A.indices[: A.nnz], np.int64)], A.indices[: A.nnz],
                                       A.indptr), shape=A.shape).sum(axis=1).A1.astype(np.int64)
            tail_pairs = int(row_pairs[np.asarray(sj.cls) == len(classes)].sum())
            assert tail_pairs > 0
            assert got.value.args == (sj.npa * W, (sj.npa - tail_pairs) * W)
        return
    got = ss._sizing(Ad, Bd, W, classes, "cpu")
    sj = js._sizing(_jax_csr(A), _jax_csr(B), W, classes)
    assert (got.npa, got.nsegB, got.counts) == (sj.npa, sj.nsegB, sj.counts)
    assert (got.counts[len(classes)] > 0) == (case == "tail")
    np.testing.assert_array_equal(got.cls.numpy(), np.asarray(sj.cls))
    np.testing.assert_array_equal(ss._rows_sorted(got, "cpu").numpy(), np.asarray(sj.rows_sorted))


@pytest.mark.parametrize("held", ["numpy", "tensors"])
def test_sizing_route_follows_the_compute_device(held):
    """Host operands and operands held in tensors both leave the sizing's
    ``structure`` on the compute device, and when B is A the same tensors
    serve B."""
    A = tsyn.webgraph_like(300, 1800, seed=4)
    A = A if held == "numpy" else A.to("cpu")
    classes = ss._norm_classes(ss.DEFAULT_CLASSES, 8)
    s = ss._sizing(A, A, 8, classes, torch.device("cpu"))
    (a_iptr, a_ind), (b_iptr, b_ind) = s.structure
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in (a_iptr, a_ind))
    assert b_iptr is a_iptr and b_ind is a_ind
    assert a_ind.numel() == A.nnz and s.cls.device.type == "cpu"


@pytest.mark.parametrize("values", ["pattern", "random"])
@pytest.mark.parametrize("case", ["rectangular", "tail"])
def test_plan_reads_the_device_sizings_structure(case, values, monkeypatch):
    """A plan on a sizing of host operands reads the structure that sizing
    copied, with the values beside it where the tables read them: no
    ``CSR.to`` of the operands (B is A: one copy), and the plan equals the
    one built from the operands' ``.to()`` (a sizing without its structure,
    as a plan caches it); the plan keeps no copy of the structure."""
    A, B, W, classes, _, _ = sizing_case(case)
    if values == "random":
        A = _with_values(A, 3)
        B = A if case == "tail" else _with_values(B, 4)
    sizing = ss._sizing(A, B, W, classes, "cpu")
    ref = spgemm_plan(A, B, classes=classes, seg_w=W, device="cpu", pattern=values == "pattern",
                      sizing=dataclasses.replace(sizing, structure=None))
    moved = []
    orig_to = CSR.to
    monkeypatch.setattr(CSR, "to", lambda self, dev: moved.append(self) or orig_to(self, dev))
    plan = spgemm_plan(A, B, classes=classes, seg_w=W, device="cpu", pattern=values == "pattern",
                       sizing=sizing)
    assert not moved
    assert_same(plan, ref)
    assert plan._sizing_cache[2].structure is None


def test_huge_expansion_row_chunking(monkeypatch):
    monkeypatch.setattr(ss, "_MAX_EXP_PAD", 4096)
    A = tsyn.webgraph_like(1000, 6000, seed=14)
    C = ss.spgemm_slab(A, A, device="cpu")
    ref = _oracle(A.to_scipy(), A.to_scipy())
    assert C.nnz == ref.nnz
    np.testing.assert_array_equal(C.indices[: C.nnz], ref.indices)
    np.testing.assert_allclose(C.data[: C.nnz], ref.data, rtol=1e-4, atol=2e-4)


def test_big_path_with_tail_rows(monkeypatch):
    """Uniform-piece big path with a row above the class ceiling: its piece
    takes the host assembly, the others the device compaction."""
    monkeypatch.setattr(ss, "_MAX_EXP_PAD", 4096)
    rng = np.random.default_rng(21)
    n = 900
    A = sp.random(n, n, density=0.015, random_state=21, format="lil", dtype=np.float32)
    A[7, :] = rng.standard_normal(n)
    A = A.tocsr()
    Ac = CSR.from_scipy(A)
    C = ss.spgemm_slab(Ac, Ac, classes=(4, 8, 16), device="cpu")
    _check(C, _oracle(A, A))


def test_big_path_tail_rows_take_no_piece_budget(monkeypatch):
    """A row above the class ceiling goes to the global-sort ESC, so its
    pairs do not count in a piece's budget: the heavy-row matrix of
    test_big_path_with_tail_rows takes a handful of pieces (1,024 one-row
    pieces when they counted), and the product stays exact."""
    monkeypatch.setattr(ss, "_MAX_EXP_PAD", 4096)
    rng = np.random.default_rng(21)
    n = 900
    A = sp.random(n, n, density=0.015, random_state=21, format="lil", dtype=np.float32)
    A[7, :] = rng.standard_normal(n)
    A = A.tocsr()
    Ac = CSR.from_scipy(A)
    calls = []
    orig_exec = ss._piece_exec
    monkeypatch.setattr(ss, "_piece_exec", lambda *a, **k: calls.append(1) or orig_exec(*a, **k))
    _check(ss.spgemm_slab(Ac, Ac, classes=(4, 8, 16), device="cpu"), _oracle(A, A))
    assert 2 <= len(calls) <= 4


def test_big_path_checkpoint_resume(monkeypatch, tmp_path):
    """A second run with the same checkpoint dir recomputes no piece;
    deleting one piece file recomputes exactly that piece; another product
    in the same dir is refused (manifest guard)."""
    monkeypatch.setattr(ss, "_MAX_EXP_PAD", 4096)
    A = tsyn.webgraph_like(1000, 6000, seed=14)
    ref = _oracle(A.to_scipy(), A.to_scipy())
    ckdir = str(tmp_path / "ck")
    calls = []
    orig_exec = ss._piece_exec

    def counting_exec(*a, **k):
        calls.append(1)
        return orig_exec(*a, **k)

    monkeypatch.setattr(ss, "_piece_exec", counting_exec)
    _check(ss.spgemm_slab(A, A, checkpoint_dir=ckdir, device="cpu"), ref)
    assert len(calls) >= 2  # the tiny budget forces a real split

    calls.clear()
    _check(ss.spgemm_slab(A, A, checkpoint_dir=ckdir, device="cpu"), ref)
    assert calls == []

    os.remove(sorted(glob.glob(os.path.join(ckdir, "piece_*.npz")))[1])
    calls.clear()
    _check(ss.spgemm_slab(A, A, checkpoint_dir=ckdir, device="cpu"), ref)
    assert len(calls) == 1

    A2 = tsyn.webgraph_like(1000, 6000, seed=15)
    with pytest.raises(ValueError, match="manifest"):
        ss.spgemm_slab(A2, A2, checkpoint_dir=ckdir, device="cpu")


def test_rmat_axa():
    A = tsyn.rmat_matrix(11, edge_factor=8, seed=19)
    C = spgemm_slab(A, A, device="cpu")
    _check(C, _oracle(A.to_scipy(), A.to_scipy()))


def test_plan_aligned_cache_parity():
    """The class-aligned cache gives bit-identical chunk outputs to the
    gathers from the plan's tables, in pattern and value modes."""
    A = tsyn.webgraph_like(1200, 7200, seed=7)
    for M in (A, _with_values(A, 8)):
        p_al = spgemm_plan(M, M, device="cpu")
        p_fe = spgemm_plan(M, M, expand=False, device="cpu")
        assert bool(p_al.aligned_cols) and not p_fe.aligned_cols
        o1, t1, _ = ss.spgemm_slab_device(M, M, plan=p_al)
        o2, t2, _ = ss.spgemm_slab_device(M, M, plan=p_fe)
        assert np.array_equal(t1, t2)
        _assert_chunks_equal(o1, o2)


def test_chain_device_matches_single():
    A = tsyn.webgraph_like(1200, 7200, seed=9)
    for M in (A, _with_values(A, 10)):
        plan = spgemm_plan(M, M, device="cpu")
        o1, _, _ = ss.spgemm_slab_device(M, M, plan=plan)
        _assert_chunks_equal(o1, ss.spgemm_chain_device(plan, 3))


def test_plan_serialize_roundtrip(tmp_path):
    """A SpgemmPlan survives save/load and the loaded plan gives
    bit-identical chunk outputs."""
    from spmm_tpu_torch.utils.serialize import load, save

    A = tsyn.webgraph_like(1100, 6600, seed=17)
    plan = spgemm_plan(A, A, device="cpu")
    path = tmp_path / "plan.npz"
    save(path, plan)
    plan2 = load(path)
    assert type(plan2).__name__ == "SpgemmPlan"
    for f in ("classes", "class_counts", "seg_w", "npa", "nrow", "slot_budget", "a_dtype",
              "b_dtype", "pattern", "aligned_accum"):
        assert getattr(plan2, f) == getattr(plan, f), f
    plan2 = plan2.to("cpu")
    o1, t1, _ = ss.spgemm_slab_device(A, A, plan=plan)
    o2, t2, _ = ss.spgemm_slab_device(A, A, plan=plan2)
    assert np.array_equal(t1, t2)
    _assert_chunks_equal(o1, o2)


def test_auto_plan_reuse(monkeypatch):
    """ops.spgemm(A, A) builds the plan on call 2 and reuses it on call 3;
    every call is exact.  Writing the values in place invalidates it."""
    monkeypatch.setattr(ss, "AUTO_PLAN_MIN_NNZ", 1)
    monkeypatch.setattr(ss, "_PLAN_SEEN", {})
    monkeypatch.setattr(ss, "_PLAN_CACHE", {})
    A = tsyn.webgraph_like(900, 5400, seed=9)
    Av = _with_values(A, 10)
    for M in (A, Av):
        ss._PLAN_SEEN.clear()
        ss._PLAN_CACHE.clear()
        ref = _oracle(M.to_scipy(), M.to_scipy())
        for call in range(3):
            C = ops.spgemm(M, M, device="cpu")
            assert C.nnz == ref.nnz, (call, C.nnz, ref.nnz)
            np.testing.assert_array_equal(C.indices[: C.nnz], ref.indices)
            np.testing.assert_allclose(C.data[: C.nnz], ref.data, rtol=1e-5, atol=1e-5)
        assert len(ss._PLAN_CACHE) == 1
    Av.data[: Av.nnz] *= 2.0
    ref2 = _oracle(Av.to_scipy(), Av.to_scipy())
    C = ops.spgemm(Av, Av, device="cpu")
    np.testing.assert_allclose(C.data[: C.nnz], ref2.data, rtol=1e-4, atol=1e-4)


def test_plan_revalue_new_values(monkeypatch):
    """spgemm_plan_revalue: same structure, new values, no new host sizing."""
    A0 = tsyn.webgraph_like(1500, 9000, seed=12)

    def run(plan, M, N):
        outs, tails, _ = ss.spgemm_slab_device(M, N, plan=plan)
        tail = (ss._tail_products(M.host(), np.asarray(tails, np.int64), N.host(), torch.float32, "cpu")
                if len(tails) else None)
        C = ss._local_csr(outs, tail, (M.nrow, N.ncol), ss._round_up(plan.npa * plan.seg_w, 1024),
                          torch.float32, "cpu")
        return ss._csr_to_host(C)

    def boom(*a, **k):
        raise AssertionError("host sizing must not re-run on revalue")

    A1, B1 = _with_values(A0, 1), _with_values(A0, 2)
    plan1 = ss.spgemm_plan(A1, B1, device="cpu")
    _check(run(plan1, A1, B1), _oracle(A1.to_scipy(), B1.to_scipy()))

    A2, B2 = _with_values(A0, 3), _with_values(A0, 4)
    monkeypatch.setattr(ss, "_sizing", boom)
    plan2 = ss.spgemm_plan_revalue(plan1, A2, B2)
    monkeypatch.undo()
    _check(run(plan2, A2, B2), _oracle(A2.to_scipy(), B2.to_scipy()))

    plan_p = ss.spgemm_plan(A0, A0, device="cpu")
    assert plan_p.pattern
    monkeypatch.setattr(ss, "_sizing", boom)
    plan_v = ss.spgemm_plan_revalue(plan_p, A1, B1)
    monkeypatch.undo()
    assert not plan_v.pattern
    _check(run(plan_v, A1, B1), _oracle(A1.to_scipy(), B1.to_scipy()))

    bad = tsyn.webgraph_like(1500, 9600, seed=13)
    with pytest.raises(ValueError):
        ss.spgemm_plan_revalue(plan1, bad, bad)


# ---- the port against the JAX package on the same inputs --------------------


def _pair(n, nnz, seed, values_seed=None):
    """The same seeded matrix from both packages' generators."""
    A, Aj = tsyn.webgraph_like(n, nnz, seed=seed), jsyn.webgraph_like(n, nnz, seed=seed)
    if values_seed is not None:
        A = _with_values(A, values_seed)
        Aj = dataclasses.replace(Aj, data=np.asarray(A.data).copy())
    return A, Aj


@pytest.mark.parametrize("values", ["pattern", "random"])
def test_spgemm_slab_matches_jax(values):
    A, Aj = _pair(1500, 9000, 21, None if values == "pattern" else 22)
    C = ops.spgemm(A, A, device="cpu")
    Cj = js.spgemm_slab(Aj, Aj)
    np.testing.assert_array_equal(C.indptr, np.asarray(Cj.indptr))
    np.testing.assert_array_equal(C.indices, np.asarray(Cj.indices[: Cj.nnz]))
    np.testing.assert_allclose(C.data, np.asarray(Cj.data[: Cj.nnz]), rtol=2e-5, atol=2e-5)
    _check(C, _oracle(A.to_scipy(), A.to_scipy()))


@pytest.mark.parametrize("seg_w", [4, 8])
def test_sizing_matches_jax(seg_w):
    """npa, nsegB, per-row class, counts and class order equal the JAX
    package's."""
    A, Aj = _pair(2500, 15000, 11)
    classes = ss._norm_classes(ss.DEFAULT_CLASSES, seg_w)
    sj = js._sizing(Aj, Aj, seg_w, classes)
    got = ss._sizing(A, A, seg_w, classes, "cpu")
    assert (got.npa, got.nsegB, got.counts) == (sj.npa, sj.nsegB, sj.counts)
    np.testing.assert_array_equal(got.cls.numpy(), np.asarray(sj.cls))
    np.testing.assert_array_equal(ss._rows_sorted(got, "cpu").numpy(), np.asarray(sj.rows_sorted))


@pytest.mark.parametrize("values", ["pattern", "random"])
def test_plan_and_chunks_match_jax(values):
    """The plan's class counts and class order equal the JAX plan's, and
    chunk by chunk: rows, nuniq and the live part of cols_u (the first nuniq
    slots of each row; past them both packages leave unspecified values)
    exactly, vals_u within 2e-5."""
    A, Aj = _pair(2000, 12000, 6, None if values == "pattern" else 5)
    plan = spgemm_plan(A, A, slot_budget=1 << 14, device="cpu")
    plan_j = js.spgemm_plan(Aj, Aj, slot_budget=1 << 14)
    assert plan.class_counts == plan_j.class_counts and plan.pattern == plan_j.pattern
    np.testing.assert_array_equal(plan.rows_sorted.numpy(), np.asarray(plan_j.rows_sorted))
    outs, tails, _ = ss.spgemm_slab_device(A, A, plan=plan)
    outs_j, tails_j, _ = js.spgemm_slab_device(Aj, Aj, plan=plan_j)
    np.testing.assert_array_equal(tails, np.asarray(tails_j))
    assert len(outs) == len(outs_j) > 1
    for (r, c, v, nu), oj in zip(outs, outs_j):
        rj, cj, vj, nuj = (np.asarray(x) for x in oj)
        np.testing.assert_array_equal(r.numpy(), rj)
        np.testing.assert_array_equal(nu.numpy(), nuj)
        live = np.arange(cj.shape[1])[None, :] < nuj[:, None]
        np.testing.assert_array_equal(c.numpy()[live], cj[live])
        np.testing.assert_allclose(v.numpy()[live], vj[live], rtol=2e-5, atol=2e-5)


def test_big_path_matches_jax(monkeypatch):
    """The streamed big path gives the JAX package's product."""
    A, Aj = _pair(600, 3600, 14, 3)
    monkeypatch.setattr(ss, "_MAX_EXP_PAD", 4096)
    monkeypatch.setattr(js, "_MAX_EXP_PAD", 4096)
    C = ss.spgemm_slab_big(A, A, pieces=4, slot_budget=1 << 14, device="cpu")
    Cj = js.spgemm_slab_big(Aj, Aj, pieces=4, slot_budget=1 << 14)
    np.testing.assert_array_equal(C.indptr, np.asarray(Cj.indptr))
    np.testing.assert_array_equal(C.indices, np.asarray(Cj.indices))
    np.testing.assert_allclose(C.data, np.asarray(Cj.data), rtol=2e-5, atol=2e-5)


# ---- the port's own contract -------------------------------------------------


def test_ops_spgemm_is_the_slab_path():
    assert ops.spgemm is ss.spgemm_slab


def test_routes_tail_rows_by_sizing_not_by_catching(monkeypatch):
    """Rows above the largest class reach the finish, ``_local_csr``, with
    their products for the host assembly because the sizing counts them; an
    error inside the device compaction propagates."""
    n = 300
    A = sp.random(n, n, density=0.03, random_state=3, format="lil", dtype=np.float32)
    A[5, :] = 1.0
    Ac = CSR.from_scipy(A.tocsr())
    finish = ss._local_csr

    def broken(outs, tail, *a):
        if tail is None:
            raise ValueError("device fault")
        return finish(outs, tail, *a)

    monkeypatch.setattr(ss, "_local_csr", broken)
    _check(spgemm_slab(Ac, Ac, classes=(4, 8), device="cpu"), _oracle(Ac.to_scipy(), Ac.to_scipy()))
    B = tsyn.webgraph_like(300, 1500, seed=2)
    with pytest.raises(ValueError, match="device fault"):
        spgemm_slab(B, B, device="cpu")


def test_chunk_slice_past_padding_raises():
    """A chunk whose rows would run past rows_sorted's padding raises instead
    of coming back short."""
    A = tsyn.webgraph_like(500, 3000, seed=4)
    plan = spgemm_plan(A, A, expand=False, device="cpu")
    n = plan.rowmeta.shape[0]
    with pytest.raises(ValueError, match="padding"):
        ss._chunk_meta(plan.rowmeta, n - 4, 4, 8, 1)


@pytest.mark.parametrize("multi", [False, True])
def test_checkpoint_io_error_keeps_piece(tmp_path, monkeypatch, multi):
    """A torn piece file is dropped and recomputed; an OSError while reading
    a piece propagates and leaves the file in place."""
    A = tsyn.webgraph_like(200, 1000, seed=1)
    ck = ss._BigCheckpoint(str(tmp_path), A, A, 2, (8,), 8, 1 << 14, "float32", True)
    triple = (np.ones(3, np.float32), np.arange(3, dtype=np.int32), np.array([0, 3], np.int64))
    save, load = (ck.save_multi, ck.load_multi) if multi else (ck.save, ck.load)
    args = (1,) if multi else ()
    save(0, [triple] if multi else triple)
    got = load(0, *args)
    got = got[0] if multi else got
    for x, y in zip(got, triple):
        np.testing.assert_array_equal(x, y)

    def io_error(*a, **k):
        raise OSError("disk went away")

    with monkeypatch.context() as m:
        m.setattr(np, "load", io_error)
        with pytest.raises(OSError):
            load(0, *args)
    assert os.path.exists(ck._piece_path(0))

    with open(ck._piece_path(0), "wb") as f:
        f.write(b"PK\x03\x04torn")
    assert load(0, *args) is None
    assert not os.path.exists(ck._piece_path(0))


# ---- the entry points compute on the card unless the caller names another ---

DEFAULT_CUDA_ENTRIES = [
    ("ops.spgemm", lambda A: ops.spgemm(A, A)),
    ("spgemm_slab_big", lambda A: ss.spgemm_slab_big(A, A, pieces=2)),
    ("ops.spgemm_sorted", lambda A: ops.spgemm_sorted(A, A)),
    ("spgemm_plan", lambda A: ss.spgemm_plan(A, A)),
    ("spgemm_slab_device", lambda A: ss.spgemm_slab_device(A, A)),
    ("spgemm_slab_csr", lambda A: ss.spgemm_slab_csr(A, A)),
]


@pytest.mark.parametrize("name,call", DEFAULT_CUDA_ENTRIES, ids=[n for n, _ in DEFAULT_CUDA_ENTRIES])
def test_default_device_is_cuda_and_raises_without_one(name, call, monkeypatch):
    """With no device named, a numpy-held product goes to ``cuda``; without a
    CUDA device that raises and names ``device="cpu"`` (no silent CPU run)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = tsyn.webgraph_like(200, 1200, seed=3)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call(A)


def test_tensor_held_operands_stay_on_their_device():
    """``device=None`` keeps a tensor-held operand where it lies (here the
    CPU), as the chained products need."""
    A = tsyn.webgraph_like(300, 1800, seed=4).to("cpu")
    plan = ss.spgemm_plan(A, A)
    assert plan.rows_sorted.device.type == "cpu"
    C = ss.spgemm_slab_csr(A, A)
    assert isinstance(C.data, torch.Tensor) and C.data.device.type == "cpu"
    _check(ss._csr_to_host(C), _oracle(A.to_scipy(), A.to_scipy()))


# ---- the result copy: pinned landings on the card, today's copy on the CPU ---

_TO_HOST_CASES = {  # name: (values, accum_dtype)
    "fp32": (True, torch.float32),
    "fp64": (True, torch.float64),
    "pattern": (False, torch.float32),
}


def _tensor_csr(case):
    """A tensor-held CSR as the device paths hand ``_csr_to_host`` one: data
    and indices padded past nnz, int32 indptr."""
    values, acc = _TO_HOST_CASES[case]
    A = tsyn.webgraph_like(300, 1800, seed=4)
    if values:
        A = _with_values(A, 9)
    C = ss.spgemm_slab_csr(A, A, accum_dtype=acc, device="cpu")
    assert C.data.shape[0] > C.nnz and C.indptr.dtype == torch.int32
    return A, C


def _assert_host_copy_of(H, C, acc):
    """H holds C's arrays cut to nnz, bit for bit, with the host CSR's dtypes."""
    assert H.indices.dtype == np.int32 and H.indptr.dtype == np.int64
    assert H.data.dtype == torch.empty(0, dtype=acc).numpy().dtype
    assert (H.nnz, H.shape) == (C.nnz, C.shape)
    assert H.data.tobytes() == C.data[: C.nnz].numpy().tobytes()
    np.testing.assert_array_equal(H.indices, C.indices[: C.nnz].numpy())
    np.testing.assert_array_equal(H.indptr, C.indptr.numpy())


@pytest.mark.parametrize("case", list(_TO_HOST_CASES))
def test_csr_to_host_of_cpu_tensors_is_the_pageable_copy(case):
    """CPU tensors take ``as_numpy`` as before the pinned landing: the same
    arrays, dtypes and values, and neither landing counter moves."""
    A, C = _tensor_csr(case)
    counts = (ss.pinned_landings, ss.pinned_fallbacks)
    H = ss._csr_to_host(C)
    assert (ss.pinned_landings, ss.pinned_fallbacks) == counts
    _assert_host_copy_of(H, C, _TO_HOST_CASES[case][1])
    _check(H, _oracle(A.to_scipy(), A.to_scipy()))


@pytest.mark.parametrize("case", list(_TO_HOST_CASES))
def test_pinned_landing_walk_gives_the_pageable_copy(case, monkeypatch):
    """``_land_pinned``'s slices, casts and copies on CPU tensors, with the
    pinned allocation (plain ``torch.empty`` here) and the stream stubbed:
    the arrays ``_csr_to_host`` gives on the CPU, one landing counted."""
    monkeypatch.setattr(ss, "_pinned_empty", lambda n, dtype: torch.empty(n, dtype=dtype))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"synchronize": lambda self: None})())
    _, C = _tensor_csr(case)
    counts = (ss.pinned_landings, ss.pinned_fallbacks)
    data, indices, indptr = ss._land_pinned(C)
    assert (ss.pinned_landings, ss.pinned_fallbacks) == (counts[0] + 1, counts[1])
    _assert_host_copy_of(CSR(data=data, indices=indices, indptr=indptr, shape=C.shape, nnz=C.nnz), C,
                         _TO_HOST_CASES[case][1])


def test_failed_pinned_allocation_counts_a_fallback(monkeypatch):
    """A pinned allocation that raises gives no landing: ``_land_pinned``
    returns None and counts one fallback, so the call goes pageable."""
    def exhausted(n, dtype):
        raise RuntimeError("CUDA error: out of memory (pinned)")

    monkeypatch.setattr(ss, "_pinned_empty", exhausted)
    _, C = _tensor_csr("fp32")
    counts = (ss.pinned_landings, ss.pinned_fallbacks)
    assert ss._land_pinned(C) is None
    assert (ss.pinned_landings, ss.pinned_fallbacks) == (counts[0], counts[1] + 1)


# ---- F9: an empty product's dtype; F10: the structural product --------------


def _csr_of_scipy(M, dtype):
    M = sp.csr_matrix(M)
    M.sort_indices()
    return CSR(data=M.data.astype(dtype), indices=M.indices.astype(np.int32),
               indptr=M.indptr.astype(np.int64), shape=M.shape, nnz=int(M.nnz))


_SPGEMM_ENTRIES = {  # name: product with the values' dtype as accum_dtype where it takes one
    "ops.spgemm": lambda A, B, dt: ops.spgemm(A, B, accum_dtype=dt, device="cpu"),
    "ops.spgemm_sorted": lambda A, B, dt: ops.spgemm_sorted(A, B, device="cpu"),
}


@pytest.mark.parametrize("empty", ["left", "right"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("entry", sorted(_SPGEMM_ENTRIES))
def test_empty_product_takes_the_dtype_of_the_non_empty_path_f9(entry, dtype, empty):
    """An empty × non-empty (or non-empty × empty) product returns its data in
    the dtype the same call gives non-empty operands of those values and that
    ``accum_dtype``; its shape and all-zero ``indptr`` are scipy's."""
    rng = np.random.default_rng(7)
    X = sp.random(5, 6, density=0.4, random_state=rng, format="csr")
    Y = sp.random(6, 4, density=0.4, random_state=rng, format="csr")
    Z = sp.csr_matrix((5, 6)) if empty == "left" else sp.csr_matrix((6, 4))
    A, B = (Z, Y) if empty == "left" else (X, Z)
    call = _SPGEMM_ENTRIES[entry]
    acc = torch.float64 if dtype == np.float64 else torch.float32
    want = call(_csr_of_scipy(X, dtype), _csr_of_scipy(Y, dtype), acc).data.dtype
    C = call(_csr_of_scipy(A, dtype), _csr_of_scipy(B, dtype), acc)
    ref = (A @ B).tocsr()
    assert np.dtype(want) == np.dtype(dtype)
    assert np.asarray(C.data).dtype == want
    assert C.nnz == 0 and tuple(C.shape) == ref.shape
    assert np.array_equal(np.asarray(C.indptr, np.int64), ref.indptr.astype(np.int64))


_F10_PROBES = {
    # partial products that cancel: C[1, 0] = 1·1 + 1·(-1) = 0
    "cancelled": (sp.csr_matrix([[1.0, 1.0], [0.0, 1.0]]), sp.csr_matrix([[1.0, 0.0], [-1.0, 2.0]])),
    # an explicit zero stored in A at (0, 1)
    "explicit zero in A": (sp.csr_matrix((np.array([1.0, 0.0]), np.array([0, 1]), np.array([0, 2])),
                                         shape=(1, 2)),
                           sp.csr_matrix([[1.0, 0.0], [0.0, 1.0]])),
}


@pytest.mark.parametrize("probe", sorted(_F10_PROBES))
@pytest.mark.parametrize("entry", sorted(_SPGEMM_ENTRIES))
def test_structural_product_keeps_cancelled_and_explicit_zeros_f10(entry, probe):
    """The port's product is structural (a known deviation from scipy, which
    drops zero sums): C's structure is scipy's product of the two patterns,
    the entries whose value is 0 hold 0, and the others hold scipy's values."""
    A, B = _F10_PROBES[probe]
    C = _SPGEMM_ENTRIES[entry](_csr_of_scipy(A, np.float32), _csr_of_scipy(B, np.float32), torch.float32)
    pat = lambda M: sp.csr_matrix((np.ones(M.nnz), M.indices, M.indptr), shape=M.shape)
    struct = _oracle(pat(A), pat(B))
    values = _oracle(A, B)
    values.eliminate_zeros()
    assert values.nnz < struct.nnz  # scipy drops what the port keeps
    assert np.array_equal(np.asarray(C.indptr, np.int64), struct.indptr.astype(np.int64))
    assert np.array_equal(np.asarray(C.indices[: C.nnz]), struct.indices)
    dense = sp.csr_matrix((np.asarray(C.data[: C.nnz]), np.asarray(C.indices[: C.nnz]),
                           np.asarray(C.indptr)), shape=C.shape).toarray()
    np.testing.assert_allclose(dense, values.toarray(), rtol=2e-5, atol=2e-5)
