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

import numpy as np
import pytest
import torch

from portbench.reference import graph_transformer as R
from spmm_tpu_torch import ops
from spmm_tpu_torch.formats import CSR, ell_pack
from spmm_tpu_torch.nn import GraphTransformer, TransformerConv
from spmm_tpu_torch.ops import attention, ell_kernel
from spmm_tpu_torch.utils.profiling import profile_fn

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


@pytest.mark.parametrize("op", ["scores", "aggregation"])
def test_leftover_rows_keep_no_gathered_rows_for_the_backward(op):
    """The leftover rows' scores (``ell_sddmm``) and their aggregation
    (``ell_spmm``'s ``spmm_xla``) save no gathered rows, one per leftover
    entry, for the backward: at a graph's size those would be an nnz × d
    pair a head and layer.  Their gradients are held to the reference by the
    layer and step tests above."""
    indptr, indices = _graph(200, 17)
    E = _pack(indptr, indices, "rest")
    entries = {E.rest.nnz, E.rest.data.shape[0]}  # the leftover entries, with and without padding
    assert 200 not in entries
    g = torch.Generator().manual_seed(18)
    Q, K = (torch.randn(200, 8, dtype=torch.float64, generator=g, requires_grad=True) for _ in range(2))
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        S = ops.ell_sddmm(E, Q, K)
        out = S.rest.data if op == "scores" else ops.ell_spmm(S, K, accum_dtype=torch.float64)
    # on the CPU the plain ordered sum (``torch.segment_reduce``) keeps its
    # input, one such tensor; the card's kernel keeps none
    kept = [s for s in shapes if len(s) == 2 and s[0] in entries]
    assert shapes and len(kept) == (op == "aggregation"), shapes
    torch.autograd.grad(out.square().sum(), [Q, K])
