"""The graph transformer (``spmm_tpu_torch/nn/graph_attention.py``) and its
sparse attention ops (``spmm_tpu_torch/ops/attention.py``: ``ell_sddmm``,
``ell_edge_softmax``, ``ell_with_values``) on the CPU, with the kernels'
plain versions, against the benchmark's plain reference
``portbench/reference/graph_transformer.py`` (gathers, ``scatter_reduce``, ``index_add_``; autograd or its closed-form
backward).  The graphs hold empty rows, rows padded in the step-of-32 length
classes and, with a small ``max_len``, rows in the pack's leftover CSR.

Tolerances: float64 against the float64 reference 1e-10 of each tensor's
largest element (the sums are taken in other orders); the float32 step
against the float64 reference as the benchmark's judge measures it, each
element against its own scale, within 1e-5.  The card's kernels are held to
these plain versions by ``tests/test_torch_cuda.py``.
"""

import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from portbench.reference import graph_transformer as R
from spmm_tpu_torch import ops
from spmm_tpu_torch.formats import CSR, ell_pack
from spmm_tpu_torch.formats.ell import ELL
from spmm_tpu_torch.nn import GraphTransformer, TransformerConv
from spmm_tpu_torch.ops import attention, ell_kernel
from spmm_tpu_torch.utils.profiling import profile_fn

ell_spmm_module = importlib.import_module("spmm_tpu_torch.ops.ell_spmm")  # the module, not ops.ell_spmm

#: the pack's length classes: the default (exact up to 64, steps of 32 above,
#: nothing left over on these graphs) and a small one whose rows above 64
#: entries go to the leftover CSR, the rows of 5-64 entries padded to 32 or 64
PACKS = {"slabs": {}, "rest": {"exact_max": 4, "step": 32, "max_len": 64}}


def _graph(n: int, seed: int):
    """``(indptr, indices)`` of an n × n pattern: rows of 0-11 entries, every
    17th empty, two of 70 and 100 entries (n at most), columns ascending."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 12, n)
    lens[::17] = 0
    lens[3], lens[11] = min(70, n), min(100, n)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    indices = np.concatenate([np.sort(rng.choice(n, int(k), replace=False)) for k in lens]).astype(np.int32)
    return indptr, indices


def _pack(indptr, indices, pack):
    n = len(indptr) - 1
    nnz = int(indptr[-1])
    return ell_pack(CSR(data=np.ones(nnz, np.float64), indices=indices, indptr=indptr, shape=(n, n), nnz=nnz),
                    **PACKS[pack])


def _close(got, ref, rel, scale=None):
    """|got - ref| within ``rel`` of ``scale``, by default ref's largest
    element (a gradient that is zero by its math, as the key bias's under a
    row softmax, takes its neighbours' scale)."""
    got, ref = got.detach().double(), ref.detach().double()
    assert got.shape == ref.shape
    scale = float(ref.abs().max()) if scale is None else scale
    assert float((got - ref).abs().max()) <= rel * max(scale, 1e-300)


def _grad_scale(grads):
    return max(float(g.abs().max()) for g in grads)


def _model(fin, heads, head_dim, layers, classes, dtype, seed):
    torch.manual_seed(seed)
    return GraphTransformer(fin, heads, head_dim, layers, classes, dtype=dtype)


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("pack", sorted(PACKS))
def test_layer_matches_the_reference(pack, heads):
    """One TransformerConv in float64: its output and the gradients of a
    loss to its eight weights and to x, against the reference's layer under
    autograd."""
    indptr, indices = _graph(200, 1)
    E = _pack(indptr, indices, pack)
    assert (E.n_rest_rows > 0) == (pack == "rest") and E.n_empty > 0
    assert any((d == 0).any() for d in E.data)  # padding slots in the slabs
    torch.manual_seed(2)
    conv = TransformerConv(6, heads, 5, dtype=torch.float64)
    x = torch.randn(200, 6, dtype=torch.float64, requires_grad=True)
    w = torch.randn(200, heads * 5, dtype=torch.float64)
    out = conv(E, x)
    got = torch.autograd.grad((out * w).sum(), [x, *conv.parameters()])
    params = {f"layers.0.{name}": p.detach().clone().requires_grad_() for name, p in conv.named_parameters()}
    xr = x.detach().clone().requires_grad_()
    rows, cols = R._edges(torch.from_numpy(indptr), torch.from_numpy(indices))
    ref = R.layer(xr, rows, cols, params, "layers.0", heads, 5, 7)[0]
    want = torch.autograd.grad((ref * w).sum(), [xr, *params.values()])
    _close(out, ref, 1e-10)
    for g, r in zip(got, want, strict=True):
        _close(g, r, 1e-10, _grad_scale(want))


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_three_layer_step_matches_the_reference(pack):
    """The 3-layer, 4-head step with its head and loss: in float64 against
    the reference under autograd (loss, logits, every gradient); in float32,
    the benchmark's precision, against the reference's closed-form float64
    step, each element against its own scale."""
    indptr, indices = _graph(240, 3)
    E = _pack(indptr, indices, pack)
    n, classes = 240, 5
    X = torch.randn(n, 7, generator=torch.Generator().manual_seed(4))
    labels = torch.randint(0, classes, (n,), generator=torch.Generator().manual_seed(5))
    train = torch.randperm(n, generator=torch.Generator().manual_seed(6))[:90].sort().values
    ip, ix = torch.from_numpy(indptr), torch.from_numpy(indices)
    for dtype in (torch.float64, torch.float32):
        model = _model(7, 4, 4, 3, classes, dtype, 7)
        assert [name for name, _ in model.named_parameters()] == R.param_names(3)
        logits = model(E, X.to(dtype))
        loss = R.loss_of(logits, labels, train)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        params = {name: p.detach().double() for name, p in model.named_parameters()}
        if dtype == torch.float64:
            pr = {name: p.clone().requires_grad_() for name, p in params.items()}
            lr = R.forward(ip, ix, X, pr, heads=4, head_dim=4, block=5)
            lossr = R.loss_of(lr, labels, train)
            want = torch.autograd.grad(lossr, list(pr.values()))
            _close(loss.detach(), lossr.detach(), 1e-12)
            _close(logits.detach(), lr.detach(), 1e-10)
            for g, r in zip(grads, want, strict=True):
                _close(g, r, 1e-10, _grad_scale(want))
            continue
        ref = R.train_step(ip, ix, X, params, labels, train, heads=4, head_dim=4, block=11)
        assert abs(loss.item() - float(ref["loss"])) <= 1e-6 * abs(float(ref["loss"]))
        scale = ref["logits"].abs().clamp(min=float(ref["logits"].square().mean().sqrt()))
        assert float(((logits.detach().double() - ref["logits"]).abs() / scale).max()) <= 1e-5
        for name, g in zip(R.param_names(3), grads, strict=True):
            s = ref["grad_scales"][name]
            err = (g.double() - ref["grads"][name]).abs() / torch.where(s > 0, s, 1.0)
            assert float(err.max()) <= 1e-5, name


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_reference_closed_form_equals_its_autograd(pack):
    """The reference's closed-form backward (the benchmark's, at any size)
    against autograd through its own forward, in blocks of 7 edges."""
    indptr, indices = _graph(150, 8)
    n = 150
    torch.manual_seed(9)
    params = {name: torch.randn(p.shape, dtype=torch.float64) * 0.4
              for name, p in _model(5, 2, 3, 2, 4, torch.float64, 9).named_parameters()}
    X = torch.randn(n, 5)
    labels, train = torch.randint(0, 4, (n,)), torch.arange(0, n, 3)
    ip, ix = torch.from_numpy(indptr), torch.from_numpy(indices)
    ref = R.train_step(ip, ix, X, params, labels, train, heads=2, head_dim=3, block=7)
    pr = {name: p.clone().requires_grad_() for name, p in params.items()}
    loss = R.loss_of(R.forward(ip, ix, X, pr, heads=2, head_dim=3, block=7), labels, train)
    want = torch.autograd.grad(loss, list(pr.values()))
    _close(ref["loss"], loss.detach(), 1e-12)
    for name, r in zip(pr, want, strict=True):
        _close(ref["grads"][name], r, 1e-10, _grad_scale(want))
        assert bool((ref["grad_scales"][name] >= ref["grads"][name].abs() * (1 - 1e-12)).all())


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_gradcheck_of_the_scores_and_the_softmax(pack):
    """``torch.autograd.gradcheck`` in float64 of ``ell_sddmm`` (to Q and K)
    and of ``ell_edge_softmax`` alone (to the values), over the slabs and the
    leftover rows."""
    indptr, indices = _graph(80, 10)
    E = _pack(indptr, indices, pack)
    g = torch.Generator().manual_seed(11)
    Q = torch.randn(80, 3, dtype=torch.float64, generator=g, requires_grad=True)
    K = torch.randn(80, 3, dtype=torch.float64, generator=g, requires_grad=True)

    def flat(V):
        return (*V.data, *((V.rest.data,) if E.n_rest_rows else ()))

    assert torch.autograd.gradcheck(lambda q, k: flat(ops.ell_sddmm(E, q, k)), (Q, K), fast_mode=True)
    S = ops.ell_sddmm(E, Q.detach(), K.detach())
    vals = [s.detach().clone().requires_grad_() for s in flat(S)]

    def softmax(*v):
        rest = v[len(E.data)] if E.n_rest_rows else None
        return flat(ops.ell_edge_softmax(E, ops.ell_with_values(E, v[: len(E.data)], rest), scale=0.7))

    assert torch.autograd.gradcheck(softmax, tuple(vals), fast_mode=True)


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_scores_softmax_and_aggregation_by_edges(pack):
    """The ops' values edge by edge, read through the pack's row order:
    scores Q_i·K_j on every edge and 0 on padding, α summing to 1 over each
    row with an edge, and ``ell_spmm`` with α zero on the empty rows."""
    indptr, indices = _graph(120, 12)
    E = _pack(indptr, indices, pack)
    g = torch.Generator().manual_seed(13)
    Q, K, V = (torch.randn(120, 4, dtype=torch.float64, generator=g) for _ in range(3))
    S = ops.ell_sddmm(E, Q, K)
    A = ops.ell_edge_softmax(E, S, scale=0.5)
    dense = torch.zeros(120, 120, dtype=torch.float64)
    perm, lo = np.asarray(E.perm), E.n_empty
    for c, s, a, d in zip(E.cols, S.data, A.data, E.data):
        rows = torch.from_numpy(perm[lo : lo + c.shape[0]].astype(np.int64))
        c = torch.from_numpy(np.asarray(c)).long()
        live = torch.from_numpy(np.asarray(d)) != 0
        want = (Q[rows][:, None, :] * K[c]).sum(-1)
        assert torch.equal(s[~live], torch.zeros_like(s[~live])) and torch.equal(a[~live], torch.zeros_like(a[~live]))
        _close(s[live], want[live], 1e-12)
        dense[rows[:, None].expand_as(c)[live], c[live]] = a[live]
        lo += c.shape[0]
    if E.n_rest_rows:
        rest = E.rest
        rr = torch.from_numpy(perm[lo:].astype(np.int64))
        seg = torch.repeat_interleave(torch.arange(E.n_rest_rows), torch.from_numpy(np.diff(rest.indptr)).long())
        cols = torch.from_numpy(np.asarray(rest.indices[: rest.nnz])).long()
        _close(S.rest.data[: rest.nnz], (Q[rr[seg]] * K[cols]).sum(-1), 1e-12)
        dense[rr[seg], cols] = A.rest.data[: rest.nnz]
    lens = np.diff(indptr)
    row_sum = dense.sum(1)
    _close(row_sum[lens > 0], torch.ones(int((lens > 0).sum()), dtype=torch.float64), 1e-12)
    assert torch.equal(row_sum[lens == 0], torch.zeros(int((lens == 0).sum()), dtype=torch.float64))
    Y = ops.ell_spmm(A, V, accum_dtype=torch.float64)
    _close(Y, dense @ V, 1e-12)
    assert torch.equal(Y[torch.from_numpy(lens == 0)], torch.zeros(int((lens == 0).sum()), 4, dtype=torch.float64))


def test_values_share_the_packs_memo_and_k2_repoints_its_table():
    """An ELL of new values shares E's memo; a memoized K2 table given other
    value slabs writes their pointers and keeps its structure, and given the
    same objects again is the same table."""
    indptr, indices = _graph(60, 14)
    E = _pack(indptr, indices, "slabs")
    V = ops.ell_with_values(E, [torch.from_numpy(np.asarray(d)).float() * 2 for d in E.data])
    assert ell_kernel.table_memo(V) is ell_kernel.table_memo(E)
    memo = {}
    dev = torch.device("cpu")
    first = [torch.from_numpy(np.asarray(d)).float() for d in E.data]
    t1 = ell_kernel._table(E.cols, first, dev, 2, memo, None)
    assert ell_kernel._table(E.cols, first, dev, 2, memo, None) is t1
    other = [d * 3 for d in first]
    before = ell_kernel.repoints
    t2 = ell_kernel._table(E.cols, other, dev, 2, memo, None)
    assert ell_kernel.repoints - before == 1
    assert t2.slabs is t1.slabs and t2.items is t1.items and memo[(dev, 2)] is t2
    assert t2.slabs[:, 1].tolist() == [d.data_ptr() for d in other]
    assert all(a is b for a, b in zip(t2.keep[1], other))
    with pytest.raises(ValueError, match="shaped as the memoized"):
        ell_kernel._table(E.cols, other[:-1], dev, 2, memo, None)


def test_views_of_one_array_are_read_in_place():
    """Slabs that lie one after another in one array (K3's and the edge
    softmax's) are the transposed product's flat values with no copy."""
    flat = torch.arange(20.0)
    views = [flat[:6].view(2, 3), flat[6:10].view(4, 1), flat[10:20].view(5, 2)]
    run = ell_kernel.flat_values(views)
    assert run.data_ptr() == flat.data_ptr() and torch.equal(run, flat)
    apart = [torch.ones(2, 3), torch.ones(4, 1)]
    assert ell_kernel._one_run(apart) is None and ell_kernel._one_run([views[1], views[0]]) is None


def test_the_layer_looks_up_its_ops_at_call_time_and_records_its_spans(monkeypatch):
    """Each head's aggregation goes through ``ops.ell_spmm`` as found on the
    package at the call (so that a replaced op is the one run); a traced
    step records the four attention spans; the counters count the softmax
    calls."""
    indptr, indices = _graph(80, 15)
    E = _pack(indptr, indices, "rest")
    model = _model(3, 2, 4, 2, 3, torch.float32, 16)
    X = torch.randn(80, 3)
    seen = []
    real = ops.ell_spmm
    monkeypatch.setattr(ops, "ell_spmm", lambda A, B, **kw: seen.append(B.shape) or real(A, B, **kw))
    s0, g0 = attention.softmax_calls, attention.softmax_grad_calls

    def step():
        loss = model(E, X).square().sum()
        return torch.autograd.grad(loss, list(model.parameters()))

    prof = profile_fn(step, warm=False)
    assert seen == [(80, 4)] * 4
    assert attention.softmax_calls - s0 == 4 and attention.softmax_grad_calls - g0 == 4
    for name in ("spmm.attn.scores", "spmm.attn.softmax", "spmm.attn.scores_bwd", "spmm.attn.softmax_bwd"):
        assert prof.spans.get(name, 0) > 0, name


class _Outputs(TorchDispatchMode):
    """The shape of every tensor each op makes while it is on."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes += [tuple(t.shape) for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        return out


@pytest.mark.parametrize("op", ["scores", "aggregation"])
def test_leftover_rows_keep_no_gathered_rows_for_the_backward(op):
    """The leftover rows' scores (``ell_sddmm``) and their aggregation
    (``ell_spmm``) ride in K2's and K3's launches as pieces: neither the
    forward nor the backward makes a tensor of gathered rows, one per
    leftover entry (at a graph's size an nnz × d tensor a head and layer),
    and none is saved for the backward.  (The plain versions' per-slab
    products, (R, L, d) tensors, are what the kernels hold in registers.)
    Their values are held to the reference by the tests above and below."""
    indptr, indices = _graph(200, 17)
    E = _pack(indptr, indices, "rest")
    entries = {E.rest.nnz, E.rest.data.shape[0]}  # the leftover entries, with and without padding
    assert 200 not in entries
    g = torch.Generator().manual_seed(18)
    Q, K = (torch.randn(200, 8, dtype=torch.float64, generator=g, requires_grad=True) for _ in range(2))
    saved, made = [], _Outputs()
    with made, torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        S = ops.ell_sddmm(E, Q, K)
        out = S.rest.data if op == "scores" else ops.ell_spmm(S, K, accum_dtype=torch.float64)
        torch.autograd.grad(out.square().sum(), [Q, K])
    gathered = lambda shapes: [s for s in shapes if len(s) == 2 and s[0] in entries and s[1] == 8]
    assert saved and made.shapes and not gathered(saved) and not gathered(made.shapes), gathered(made.shapes)
    assert any(s == (E.rest.data.shape[0],) for s in made.shapes)  # one scalar an entry, as the reorders make


# ---- the leftover rows cut into pieces (ell_kernel.RestPieces) -------------

#: cuts of the leftover rows into pieces: the default (each leftover row of
#: these graphs one piece), the pack's max_len (rows of max_len + 1 and
#: 2·max_len + 1 entries cut into two and three, the last piece of one entry)
#: and 8 (many pieces a row)
CUTS = [ell_kernel.T_CUT, 64, 8]
#: the long rows of :func:`_long_graph`: exactly max_len (a slab row), then
#: rows left over
LONG = {3: 64, 11: 65, 20: 100, 40: 129, 41: 200}


def _long_graph(n: int, seed: int):
    """``(indptr, indices, data)`` of an n × n pattern as :func:`_graph`'s,
    with the rows of ``LONG``; one entry of the 200-entry row has the value
    0: padding in E inside a leftover row, no edge."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 12, n)
    lens[::17] = 0
    for row, k in LONG.items():
        lens[row] = k
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    indices = np.concatenate([np.sort(rng.choice(n, int(k), replace=False)) for k in lens]).astype(np.int32)
    data = np.ones(len(indices))
    data[indptr[41] + 7] = 0
    return indptr, indices, data


def _cut_pack(cut: int, n: int = 300, seed: int = 30):
    """The :func:`_long_graph` pack with max_len 64 and its leftover rows cut
    at ``cut`` (memoized where the ops find it), the pieces, and the graph's
    edges for the reference, without the zero."""
    indptr, indices, data = _long_graph(n, seed)
    E = ell_pack(CSR(data=data, indices=indices, indptr=indptr, shape=(n, n), nnz=len(indices)), **PACKS["rest"])
    dev = torch.device("cpu")
    out_rows, rest_rows, _ = ell_spmm_module._row_maps(E, dev)
    P = ell_kernel.rest_pieces(E.cols, out_rows, lambda: ell_spmm_module.slab_row_keys(E), E.rest, rest_rows,
                               n, dev, cut=cut)
    ell_kernel.table_memo(E)[("pieces", dev)] = P
    keep = data != 0
    ip = np.concatenate([[0], np.cumsum(np.add.reduceat(keep, indptr[:-1]) * (np.diff(indptr) > 0))])
    return E, P, torch.from_numpy(ip), torch.from_numpy(indices[keep])


def _dense(E, values: ELL, n: int):
    """The n × n matrix of ``values`` on E's slots, read through E's row order."""
    dense = torch.zeros(n, n, dtype=torch.float64)
    perm, lo = np.asarray(E.perm).astype(np.int64), E.n_empty
    for c, v in zip(E.cols, values.data):
        rows = torch.from_numpy(perm[lo : lo + c.shape[0]])[:, None].expand(c.shape)
        dense.index_put_((rows.reshape(-1), torch.from_numpy(np.asarray(c)).long().reshape(-1)),
                         torch.as_tensor(v).detach().double().reshape(-1), accumulate=True)
        lo += c.shape[0]
    seg = torch.repeat_interleave(torch.from_numpy(perm[lo:]), torch.from_numpy(np.diff(E.rest.indptr)).long())
    cols = torch.from_numpy(np.asarray(E.rest.indices[: E.rest.nnz])).long()
    dense.index_put_((seg, cols), torch.as_tensor(values.rest.data)[: E.rest.nnz].detach().double(), accumulate=True)
    return dense


@pytest.mark.parametrize("cut", CUTS)
def test_pieces_cut_every_leftover_row_once(cut):
    """Each leftover row's entries in pieces of at most ``cut``, in order,
    each entry in one slot (the reorders ``src`` and ``dst`` inverse to each
    other), a last piece padded by < 32 slots; an uncut row's piece written
    at its row, a cut row's at scratch rows past m in order, joined into the
    row; the row of exactly max_len entries in a slab."""
    E, P, _, _ = _cut_pack(cut)
    n, m = 300, 300
    perm = np.asarray(E.perm)
    rest_rows = perm[m - E.n_rest_rows :]
    assert sorted(rest_rows) == [11, 20, 40, 41] and 3 in perm[E.n_empty : m - E.n_rest_rows]
    want = {row: -(-LONG[row] // cut) for row in rest_rows}
    assert P.count == sum(want.values()) and list(np.diff(P.piece_offsets)) == [want[r] for r in rest_rows]
    assert int(P.piece_len.max()) <= cut and P.piece_len.sum() == E.rest.nnz
    pieces = P.cols[len(E.cols) :]
    assert len(pieces) == P.piece_slabs and sum(int(c.shape[0]) for c in pieces) == P.count
    src, dst = P.src.numpy(), P.dst.numpy()
    nnz_pad = E.rest.data.shape[0]
    live = src < nnz_pad
    assert sorted(src[live]) == list(range(E.rest.nnz))  # every entry in one slot
    np.testing.assert_array_equal(dst[src[live]], np.nonzero(live)[0])
    assert (dst[E.rest.nnz :] == len(src)).all()
    flat_cols = np.concatenate([c.numpy().reshape(-1) for c in pieces])
    np.testing.assert_array_equal(flat_cols[live], np.asarray(E.rest.indices)[src[live]])
    off = 0
    for c in pieces:  # a piece's padding: < 32 slots, after its entries
        R, L = c.shape
        used = live[off : off + R * L].reshape(R, L)
        assert (L - used.sum(1) < 32).all() and (np.sort(~used, 1) == ~used).all()
        off += R * L
    if cut == 64:  # the rows of max_len + 1 and 2·max_len + 1: a last piece of one entry
        assert any(c.shape[1] == 1 for c in pieces)
    read, write = P.read_rows.numpy()[-P.count :], P.write_rows.numpy()[-P.count :]
    cut_rows = [r for r in rest_rows if want[r] > 1]
    single = np.isin(read, cut_rows, invert=True)
    np.testing.assert_array_equal(write[single], read[single])
    assert sorted(write[~single]) == list(range(m, m + P.scratch)) and P.scratch == sum(want[r] for r in cut_rows)
    assert P.join_rows.tolist() == cut_rows
    np.testing.assert_array_equal(P.read_rows.numpy()[: -P.count], P.write_rows.numpy()[: -P.count])
    for r in cut_rows:  # a cut row's scratch rows are consecutive, in its pieces' order
        j = cut_rows.index(r)
        lo, hi = int(P.join_plan.offsets[j]), int(P.join_plan.offsets[j + 1])
        assert sorted(write[read == r]) == list(range(m + lo, m + hi))
    assert P.row_keys.shape == (sum(int(c.shape[0]) for c in P.cols),) and n == m


@pytest.mark.parametrize("cut", CUTS)
def test_pieces_match_the_reference(cut):
    """Scores, softmax and aggregation over a pack whose leftover rows take
    one, two and three, or many pieces, and the gradients to Q, K and V, in
    float64 against the reference's layer (its Q, K and V the columns of x,
    no skip), edge by edge; a second run gives the same bits."""
    E, _, ip, ix = _cut_pack(cut)
    n, d = 300, 4
    eye = torch.eye(d, dtype=torch.float64)
    zero = torch.zeros(d, d, dtype=torch.float64)
    params = {f"l.{lin}.weight": torch.cat([eye if i == j else zero for j in range(3)], 1)
              for i, lin in enumerate(R.LINS[:3])}
    params["l.lin_skip.weight"] = torch.zeros(d, 3 * d, dtype=torch.float64)
    params.update({f"l.{lin}.bias": torch.zeros(d, dtype=torch.float64) for lin in R.LINS})
    x = torch.randn(n, 3 * d, dtype=torch.float64, generator=torch.Generator().manual_seed(31))
    W = torch.randn(n, d, dtype=torch.float64, generator=torch.Generator().manual_seed(32))
    xr = x.clone().requires_grad_()
    rows, cols = R._edges(ip, ix)
    ref, _, _, _, alpha = R.layer(xr, rows, cols, params, "l", 1, d, 7)
    (want,) = torch.autograd.grad((ref * W).sum(), [xr])

    def run():
        Q, K, V = (x[:, i * d : (i + 1) * d].clone().requires_grad_() for i in range(3))
        S = ops.ell_sddmm(E, Q, K)
        A = ops.ell_edge_softmax(E, S, scale=d ** -0.5)
        Y = ops.ell_spmm(A, V, accum_dtype=torch.float64)
        return S, A, Y, torch.autograd.grad((Y * W).sum(), [Q, K, V])

    S, A, Y, grads = run()
    qk = torch.zeros(n, n, dtype=torch.float64)
    qk[rows, cols] = (x[rows, :d] * x[cols, d : 2 * d]).sum(1)
    _close(_dense(E, S, n), qk, 1e-12)  # 0 on padding, the zero entry included
    dense_alpha = torch.zeros(n, n, dtype=torch.float64)
    dense_alpha[rows, cols] = alpha[:, 0].detach()
    _close(_dense(E, A, n), dense_alpha, 1e-12)
    _close(Y, ref, 1e-10)
    _close(torch.cat(grads, 1), want, 1e-10)
    again = run()
    assert torch.equal(Y, again[2]) and all(torch.equal(a, b) for a, b in zip(grads, again[3], strict=True))
    assert torch.equal(S.rest.data, again[0].rest.data) and torch.equal(A.rest.data, again[1].rest.data)


@pytest.mark.parametrize("cut", CUTS)
def test_pieces_layer_matches_the_reference(cut):
    """One 2-head TransformerConv in float64 over the cut pack: its output
    and the gradients to its weights and to x against the reference's
    layer under autograd."""
    E, _, ip, ix = _cut_pack(cut)
    torch.manual_seed(33)
    conv = TransformerConv(6, 2, 5, dtype=torch.float64)
    x = torch.randn(300, 6, dtype=torch.float64, requires_grad=True)
    w = torch.randn(300, 10, dtype=torch.float64)
    out = conv(E, x)
    got = torch.autograd.grad((out * w).sum(), [x, *conv.parameters()])
    params = {f"layers.0.{name}": p.detach().clone().requires_grad_() for name, p in conv.named_parameters()}
    xr = x.detach().clone().requires_grad_()
    rows, cols = R._edges(ip, ix)
    ref = R.layer(xr, rows, cols, params, "layers.0", 2, 5, 7)[0]
    want = torch.autograd.grad((ref * w).sum(), [xr, *params.values()])
    _close(out, ref, 1e-10)
    for g, r in zip(got, want, strict=True):
        _close(g, r, 1e-10, _grad_scale(want))


@pytest.mark.parametrize("cut", CUTS)
def test_gradcheck_through_the_joined_softmax(cut):
    """``torch.autograd.gradcheck`` in float64 of ``ell_edge_softmax`` over a
    pack whose leftover rows are cut (the pieces' maxima and sums joined per
    row) to every value, the leftover entries' in the CSR's order, and of
    ``ell_sddmm`` to Q and K."""
    E, _, _, _ = _cut_pack(cut, n=210, seed=34)
    g = torch.Generator().manual_seed(35)
    Q, K = (torch.randn(210, 3, dtype=torch.float64, generator=g, requires_grad=True) for _ in range(2))
    flat = lambda V: (*V.data, V.rest.data)
    assert torch.autograd.gradcheck(lambda q, k: flat(ops.ell_sddmm(E, q, k)), (Q, K), fast_mode=True)
    S = ops.ell_sddmm(E, Q.detach(), K.detach())
    vals = [v.detach().clone().requires_grad_() for v in flat(S)]
    softmax = lambda *v: flat(ops.ell_edge_softmax(E, ops.ell_with_values(E, v[:-1], v[-1]), scale=0.7))
    assert torch.autograd.gradcheck(softmax, tuple(vals), fast_mode=True)


@pytest.mark.parametrize("cut", CUTS)
def test_ell_spmm_over_pieces_matches_dense(cut):
    """``ops.ell_spmm`` of an ELL with values over the cut pack: the product
    and the gradient to B against the dense matrix, the gradient to each
    value (a slab slot's, or a leftover entry's in the CSR's order, 0 on its
    padding) against dY's row times B's; a second run gives the same bits;
    an ELL with no leftover rows builds no pieces."""
    E, _, _, _ = _cut_pack(cut)
    g = torch.Generator().manual_seed(36)
    data = [(torch.randn(d.shape, dtype=torch.float64, generator=g) * torch.from_numpy(np.asarray(d))).requires_grad_()
            for d in E.data]
    rest = (torch.randn(E.rest.data.shape, dtype=torch.float64, generator=g)
            * torch.from_numpy(np.asarray(E.rest.data))).requires_grad_()
    B = torch.randn(300, 5, dtype=torch.float64, generator=g).requires_grad_()
    W = torch.randn(300, 5, dtype=torch.float64, generator=g)

    def run():
        y = ops.ell_spmm(ops.ell_with_values(E, data, rest), B, accum_dtype=torch.float64)
        return y, torch.autograd.grad((y * W).sum(), [B, *data, rest])

    y, grads = run()
    dense = _dense(E, ops.ell_with_values(E, data, rest), 300)
    _close(y, dense @ B.detach(), 1e-12)
    _close(grads[0], dense.T @ W, 1e-12)
    perm, lo = np.asarray(E.perm).astype(np.int64), E.n_empty
    for c, gd in zip(E.cols, grads[1:-1]):
        c = torch.from_numpy(np.asarray(c)).long()
        rows = torch.from_numpy(perm[lo : lo + c.shape[0]])
        _close(gd, (W[rows][:, None, :] * B.detach()[c]).sum(-1), 1e-12)
        lo += c.shape[0]
    nnz = E.rest.nnz
    seg = torch.repeat_interleave(torch.from_numpy(perm[lo:]), torch.from_numpy(np.diff(E.rest.indptr)).long())
    want = (W[seg] * B.detach()[torch.from_numpy(np.asarray(E.rest.indices[:nnz])).long()]).sum(-1)
    _close(grads[-1][:nnz], want, 1e-12)
    assert not grads[-1][nnz:].any()
    again = run()
    assert torch.equal(y, again[0]) and all(torch.equal(a, b) for a, b in zip(grads, again[1], strict=True))
    indptr, indices = _graph(60, 37)
    plain = _pack(indptr, indices, "slabs")
    ops.ell_spmm(plain, torch.randn(60, 3))
    assert not any(k[0] == "pieces" for k in ell_kernel.table_memo(plain) if isinstance(k, tuple))
