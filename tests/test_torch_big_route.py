"""``ops.spgemm``'s streamed piece route (``spgemm_slab_big``) on the CPU,
with ``_MAX_EXP_PAD`` cut so that a web graph of a few thousand rows takes
it: C against the benchmark's plain reference (``portbench/reference/``),
the route's counter, and its spans under ``torch.profiler`` (none without
one).  BASELINE config 5 takes this route at full size on the card."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.judge import scaled_err
from portbench.reference.spgemm import spgemm as spgemm_reference
from spmm_tpu_torch import ops
from spmm_tpu_torch.formats import CSR
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.ops import slab_spgemm as ss

from torch_parity import one_torch_thread, rhs  # noqa: F401  (autouse)

#: ~2^17.5 padded slots of the graphs below: the route starts at 8 pieces
SMALL_BUDGET = 1 << 16
BIG_SPANS = ("spmm.spgemm.big", "spmm.spgemm.big.split", "spmm.spgemm.big.piece", "spmm.spgemm.big.stitch")


def _graph(seed: int):
    A = tsyn.webgraph_like(3000, 18000, seed=seed)
    return dataclasses.replace(A, data=rhs(1, A.nnz_pad, seed)[0])


def _span_counts(events) -> dict:
    out = dict.fromkeys(BIG_SPANS, 0)
    for e in events:
        if e.name in out:
            out[e.name] += 1
    return out


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
def test_ops_spgemm_takes_the_piece_route_and_matches_the_reference(seed, monkeypatch):
    """C's structure is the reference's exactly, its values within the
    benchmark's 1e-4 of each row's sum of absolute partial products (the
    plain merge's prefix differences keep to the row's scale), and the
    product is counted once by the route."""
    monkeypatch.setattr(ss, "_MAX_EXP_PAD", SMALL_BUDGET)
    A = _graph(seed)
    before = ss.big_products
    C = ops.spgemm(A, A, device="cpu")
    assert ss.big_products - before == 1

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ip, ix, dv = t(A.indptr), t(A.indices[: A.nnz]), t(A.data[: A.nnz])
    r_ptr, r_idx, r_val, r_scale = spgemm_reference(ip, ix, dv, ip, ix, dv, A.shape[1])
    assert np.array_equal(np.asarray(C.indptr, np.int64), r_ptr.numpy())
    assert np.array_equal(np.asarray(C.indices[: C.nnz], np.int64), r_idx.numpy())
    rows = torch.repeat_interleave(torch.arange(A.shape[0]), r_ptr.diff())
    row_scale = torch.zeros(A.shape[0], dtype=torch.float64).index_add_(0, rows, r_scale)[rows]
    assert scaled_err(torch.from_numpy(np.asarray(C.data[: C.nnz])), r_val, row_scale) <= 1e-4


@pytest.mark.parametrize("route", ["ops.spgemm", "one_piece_first", "checkpoint_resume"])
def test_the_big_spans_count_the_pieces_and_the_rounds(route, monkeypatch, tmp_path):
    """Under a CPU profiler: one stitch span a product, and one
    ``spmm.spgemm.big`` where ``ops.spgemm`` chose the route; as many piece
    spans as the triples ``_stitch`` gets, as many split spans as
    ``rows_per_shard`` calls (a round's block height); a search started at
    one piece takes several rounds, and a resumed product's pieces read from
    their checkpoint files are pieces too."""
    from spmm_tpu_torch.parallel import partition

    monkeypatch.setattr(ss, "_MAX_EXP_PAD", SMALL_BUDGET)
    A = _graph(3)
    seen = {"pieces": 0, "rounds": 0}
    stitch, split = ss._stitch, partition.rows_per_shard

    def counted_stitch(triples, *a):
        seen["pieces"] += len(triples)
        return stitch(triples, *a)

    def counted_split(*a, **k):
        seen["rounds"] += 1
        return split(*a, **k)

    if route == "ops.spgemm":
        run = lambda: ops.spgemm(A, A, device="cpu")
    elif route == "one_piece_first":
        run = lambda: ss.spgemm_slab_big(A, A, pieces_hint=1, device="cpu")
    else:
        ck = str(tmp_path / "ck")
        ss.spgemm_slab_big(A, A, checkpoint_dir=ck, device="cpu")
        run = lambda: ss.spgemm_slab_big(A, A, checkpoint_dir=ck, device="cpu")
    monkeypatch.setattr(ss, "_stitch", counted_stitch)
    monkeypatch.setattr(partition, "rows_per_shard", counted_split)
    before = ss.big_products
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        C = run()
    spans = _span_counts(prof.events())
    assert ss.big_products - before == 1 and spans["spmm.spgemm.big.stitch"] == 1
    assert spans["spmm.spgemm.big"] == (route == "ops.spgemm")
    assert spans["spmm.spgemm.big.piece"] == seen["pieces"] >= 2
    assert spans["spmm.spgemm.big.split"] == seen["rounds"] >= (3 if route == "one_piece_first" else 1)
    S = (A.to_scipy() @ A.to_scipy()).sorted_indices()
    assert np.array_equal(np.asarray(C.indptr, np.int64), S.indptr)
    assert np.array_equal(C.indices[: C.nnz], S.indices)


def test_no_big_span_is_made_without_a_profiler(monkeypatch):
    """With no profiler running the route's spans are the shared no-op: no
    ``record_function`` is made, and the counter still counts."""

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(ss, "_MAX_EXP_PAD", SMALL_BUDGET)
    A = _graph(4)
    before = ss.big_products
    ops.spgemm(A, A, device="cpu")
    assert ss.big_products - before == 1


def _with_heavy_row(A, values: bool):
    """A with row 7 made dense: its padded expansion is above the largest
    class, so it takes the global-sort ESC as a tail row."""
    S = A.to_scipy().tolil()
    S[7, :] = rhs(1, A.shape[1], 17)[0] if values else 1.0
    return CSR.from_scipy(S.tocsr(), np.float32)


@pytest.mark.parametrize("values", [False, True], ids=["pattern", "values"])
@pytest.mark.parametrize("heavy", [False, True], ids=["no_tail_row", "one_heavy_row"])
def test_one_call_and_pieces_give_the_same_c(heavy, values, monkeypatch):
    """The same product through ``ops.spgemm``'s single call and, with
    ``_MAX_EXP_PAD`` cut, through its piece route: ``indptr`` and
    ``indices`` equal, data within 1e-6 relative (pieces size without the
    class fold, so their chunks may differ)."""
    A = _graph(6) if values else tsyn.webgraph_like(3000, 18000, seed=6)
    if heavy:
        A = _with_heavy_row(A, values)
    classes = ss._norm_classes(ss.DEFAULT_CLASSES, ss.DEFAULT_SEG_W)
    assert (ss._sizing(A, A, ss.DEFAULT_SEG_W, classes, "cpu").counts[-1] > 0) == heavy
    before = ss.big_products
    one = ops.spgemm(A, A, device="cpu")
    assert ss.big_products == before
    monkeypatch.setattr(ss, "_MAX_EXP_PAD", SMALL_BUDGET)
    pieces = ops.spgemm(A, A, device="cpu")
    assert ss.big_products == before + 1
    np.testing.assert_array_equal(np.asarray(pieces.indptr, np.int64), np.asarray(one.indptr, np.int64))
    np.testing.assert_array_equal(pieces.indices[: pieces.nnz], one.indices[: one.nnz])
    np.testing.assert_allclose(pieces.data[: pieces.nnz], one.data[: one.nnz], rtol=1e-6, atol=0)


def _block_by_block_split(A, B, W, classes, pieces, P0, nsh):
    """The piece search block by block, as a reference: ``partition_rows``
    and ``_per_shard_sizing`` each round,
    P doubled on an int32 overflow and, unless ``pieces`` is given, until the
    largest block's body slots fit the budget or the blocks are one row."""
    from spmm_tpu_torch.parallel.partition import partition_rows

    P = pieces or P0
    while True:
        S = partition_rows(A, nsh * P)
        at_min = S.rows_per_shard <= 1 or nsh * P >= A.nrow
        try:
            sizing = ss._per_shard_sizing(S, B, W, classes)
        except ValueError:
            if at_min:
                raise
            P *= 2
            continue
        if pieces is not None or sizing[4].max(initial=0) * W <= ss._MAX_EXP_PAD or at_min:
            return P, S.rows_per_shard, sizing
        P *= 2


#: name: (A or (A, B), W, classes or None for the defaults, nsh, pieces,
#: P0, budget); each last block is padded past A's last row
SPLIT_CASES = {
    "heavy_row_search": (lambda: _with_heavy_row(_graph(6), True), 8, None, 1, None, 1, SMALL_BUDGET),
    "heavy_row_three_shards": (lambda: _with_heavy_row(_graph(6), True), 8, None, 3, None, 1, SMALL_BUDGET),
    "given_pieces_three_shards": (lambda: _graph(7), 8, None, 3, 4, 1, None),
    "rectangular_b": (lambda: (tsyn.webgraph_like(3001, 20000, seed=8), tsyn.webgraph_like(3001, 9000, seed=9)),
                      4, None, 1, None, 1, SMALL_BUDGET),
    "one_row_blocks": (lambda: tsyn.webgraph_like(21, 120, seed=10), 8, None, 1, None, 1, 64),
    # every pair is 2^20 slots: blocks of over 2,047 nonzeros overflow int32,
    # so P doubles past the pieces asked for
    "int32_doubling": (lambda: _graph(11), 1 << 20, (1 << 20,), 3, 2, 1, None),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_the_split_from_the_per_row_sizing_equals_the_per_block_host_sizing(case, monkeypatch):
    """``_choose_pieces`` cut from each row's padded expansion and raw class
    gives the P of the block-by-block search and, element for element, the
    ``_per_shard_sizing(partition_rows(A, nsh * P), B, W, classes)`` of its
    blocks (classes, counts, npa_max, nnz, body pairs) in their dtypes and
    shapes; it empties the per-row list it was handed."""
    make, W, classes, nsh, pieces, P0, budget = SPLIT_CASES[case]
    if budget is not None:
        monkeypatch.setattr(ss, "_MAX_EXP_PAD", budget)
    got = make()
    A, B = got if isinstance(got, tuple) else (got, got)
    classes = classes or ss._norm_classes(ss.DEFAULT_CLASSES, W)
    P, R, want = _block_by_block_split(A, B, W, classes, pieces, P0, nsh)
    rows = ss._row_expansion(A, B, W, classes, "cpu")
    got_P, got_R, sizing, body_max = ss._choose_pieces(A, rows, W, classes, pieces, P0, nsh=nsh)
    assert rows == [] and (got_P, got_R) == (P, R) and body_max == int(want[4].max(initial=0))
    assert nsh * P * R > A.nrow
    if case == "given_pieces_three_shards":
        assert P == pieces
    else:  # the others take more than one round
        assert P > (pieces or P0)
    for name, g, w in zip(("cls", "counts", "npa_max", "nnz", "body"), sizing, want):
        if isinstance(w, np.ndarray):
            assert (g.dtype, g.shape) == (w.dtype, w.shape), name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name
    if case == "int32_doubling":
        from spmm_tpu_torch.parallel.partition import partition_rows

        with pytest.raises(ValueError, match="int32"):
            ss._per_shard_sizing(partition_rows(A, nsh * P // 2), B, W, classes)


@pytest.mark.parametrize("heavy", [False, True], ids=["no_tail_row", "one_heavy_row"])
def test_the_piece_route_splits_from_the_sizing_it_already_ran(heavy, monkeypatch):
    """``ops.spgemm`` on the piece route cuts its pieces from the per-row
    result of the whole-A sizing that overflowed: no ``partition_rows`` and
    no per-block host sizing, ``split_from_sizing`` one up a product.  A
    direct ``spgemm_slab_big`` from the same piece hint computes that
    per-row pass itself (the counter stays) and gives the same C, bit for
    bit."""
    from spmm_tpu_torch.parallel import partition

    monkeypatch.setattr(ss, "_MAX_EXP_PAD", SMALL_BUDGET)
    A = _graph(12)
    if heavy:
        A = _with_heavy_row(A, True)
    hints, choose = [], ss._choose_pieces

    def spy(A, rows, W, classes, pieces, P0, nsh=1):
        hints.append(P0)
        return choose(A, rows, W, classes, pieces, P0, nsh)

    def refuse(*a, **k):
        raise AssertionError("the piece route walked A's blocks on the host")

    monkeypatch.setattr(ss, "_choose_pieces", spy)
    monkeypatch.setattr(ss, "_per_shard_sizing", refuse)
    monkeypatch.setattr(partition, "partition_rows", refuse)
    before = (ss.big_products, ss.split_from_sizing)
    routed = [ops.spgemm(A, A, device="cpu") for _ in range(2)]
    assert (ss.big_products - before[0], ss.split_from_sizing - before[1]) == (2, 2)
    direct = ss.spgemm_slab_big(A, A, pieces_hint=hints[0], device="cpu")
    assert (ss.big_products - before[0], ss.split_from_sizing - before[1]) == (3, 2)
    assert len(set(hints)) == 1
    for C in routed:
        for name in ("indptr", "indices", "data"):
            g, w = getattr(C, name), getattr(direct, name)
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name
