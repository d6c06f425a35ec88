"""A plain reference of a graph-transformer training step: UniMP's
TransformerConv layers (Shi et al., IJCAI 2021; PyTorch Geometric's
``TransformerConv`` with ``concat=True``, ``beta=False``, no edge features,
no dropout), ReLU between them, a linear head and the mean cross-entropy
over the train nodes, on the graph A given as CSR arrays (row i aggregates
over its columns j).

Plain torch: gathers, ``scatter_reduce`` (amax) and ``index_add_``, in the
``dtype`` asked for (float64 for the reference, bfloat16 for a control that
must fail a comparison).  Edges are taken in blocks of ``block``, so that the
gathered rows fit beside anything on the device.  :func:`forward` is
differentiable by autograd (small sizes); :func:`train_step` computes the
gradients by their closed form, recomputing each layer's forward in its
backward and keeping only each layer's input, so that it runs at full size.
It imports nothing of the program under test.

Parameters are a dict by the names of :func:`param_names`
(``layers.<l>.lin_query.weight``, ... ``head.bias``), weights (out, in).
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LINS = ("lin_query", "lin_key", "lin_value", "lin_skip")


def param_names(layers: int) -> list:
    """The parameters' names, in the order of the program's
    ``named_parameters()``."""
    names = [f"layers.{i}.{lin}.{p}" for i in range(layers) for lin in LINS for p in ("weight", "bias")]
    return names + ["head.weight", "head.bias"]


def _edges(indptr, indices):
    ptr = indptr.long()
    n, nnz = len(ptr) - 1, int(ptr[-1])
    rows = torch.repeat_interleave(torch.arange(n, device=ptr.device), ptr[1:] - ptr[:-1])
    return rows, indices[:nnz].long()


def _blocks(nnz: int, block: int):
    return [(s, min(s + block, nnz)) for s in range(0, nnz, block)]


def _lin(x, params, name):
    return torch.addmm(params[name + ".bias"], x, params[name + ".weight"].t())


def layer(x, rows, cols, params, pre, heads, head_dim, block, *, aggregate=True):
    """``(out, q, k, v, alpha)`` of one layer: q, k, v (n, H, d), alpha
    (nnz, H), out (n, H·d) before the ReLU (None unless ``aggregate``).
    Under autograd every step is out of place; without it the scores
    become alpha in place and the skip product adds into the aggregate, so
    that a full-size layer holds q, k, v, one value an edge and a head, and
    one (n, H·d) result."""
    n = x.shape[0]
    grad = torch.is_grad_enabled()
    q, k, v = (_lin(x, params, f"{pre}.{lin}").view(n, heads, head_dim) for lin in LINS[:3])
    spans = _blocks(rows.numel(), block)
    c = 1.0 / math.sqrt(head_dim)
    if grad:
        s = torch.cat([(q[rows[a:b]] * k[cols[a:b]]).sum(-1) for a, b in spans]) * c
    else:
        s = torch.empty((rows.numel(), heads), dtype=q.dtype, device=q.device)
        for a, b in spans:
            torch.sum(q[rows[a:b]] * k[cols[a:b]], -1, out=s[a:b])
        s.mul_(c)
    s = s.reshape(-1, heads)
    m = torch.full((n, heads), -math.inf, dtype=s.dtype, device=s.device)
    m = m.scatter_reduce(0, rows[:, None].expand(-1, heads), s.detach(), "amax")  # a shift: no gradient
    den = torch.zeros((n, heads), dtype=s.dtype, device=s.device)
    if grad:
        e = torch.exp(s - m[rows])
        alpha = e / den.index_add(0, rows, e)[rows]
    else:
        for a, b in spans:
            s[a:b].sub_(m[rows[a:b]]).exp_()
        den.index_add_(0, rows, s)
        for a, b in spans:
            s[a:b].div_(den[rows[a:b]])
        alpha = s
    out = None
    if aggregate:
        out = torch.zeros((n, heads, head_dim), dtype=s.dtype, device=s.device)
        for a, b in spans:
            src = alpha[a:b, :, None] * v[cols[a:b]]
            out = out.index_add(0, rows[a:b], src) if grad else out.index_add_(0, rows[a:b], src)
        skip = f"{pre}.lin_skip"
        if grad:
            out = out.reshape(n, heads * head_dim) + _lin(x, params, skip)
        else:
            out = out.view(n, heads * head_dim).addmm_(x, params[skip + ".weight"].t()).add_(params[skip + ".bias"])
    return out, q, k, v, alpha


def forward(indptr, indices, X, params, *, heads: int, head_dim: int, dtype=torch.float64,
            block: int = 1 << 19):
    """The logits (n, classes) in ``dtype``; differentiable by autograd with
    respect to ``params`` (cast to ``dtype`` here)."""
    layers = (len(params) - 2) // 8
    p = {name: t.to(dtype) for name, t in params.items()}
    rows, cols = _edges(indptr, indices)
    x = X.to(dtype)
    for i in range(layers):
        x = layer(x, rows, cols, p, f"layers.{i}", heads, head_dim, block)[0]
        if i + 1 < layers:
            x = torch.relu(x)
    return _lin(x, p, "head")


def loss_of(logits, labels, train):
    """The mean cross-entropy over the train nodes."""
    return torch.nn.functional.cross_entropy(logits[train], labels[train].long())


def _backward(xs, h, dlog, rows, cols, p, heads, head_dim, block, absolute: bool) -> dict:
    """The gradient of every parameter from the logits' gradient ``dlog``,
    layer by layer, each layer's forward recomputed from its input ``xs[i]``
    (``h``: the last layer's output).  With ``absolute``, every factor is
    taken by its absolute value and the softmax's subtraction becomes an
    addition: each element is then the sum of the absolute values of all
    the terms of that element of the gradient, through every layer above
    it, the size its rounding is measured against."""
    mag = torch.abs if absolute else (lambda t: t)  # noqa: E731
    n, layers = xs[0].shape[0], len(xs)
    width = heads * head_dim
    out = {}

    def keep(name, dY, x):
        out[name + ".weight"] = (dY.t() @ mag(x)).double()
        out[name + ".bias"] = dY.sum(0).double()

    keep("head", dlog, h)
    dy = dlog @ mag(p["head.weight"])
    for i in reversed(range(layers)):
        pre = f"layers.{i}"
        if i + 1 < layers:
            dy.mul_(xs[i + 1] > 0)  # the ReLU's
        x = xs[i]
        _, q, k, v, alpha = layer(x, rows, cols, p, pre, heads, head_dim, block, aggregate=False)
        q, k, v = mag(q), mag(k), mag(v)
        dagg = dy.view(n, heads, head_dim)
        spans = _blocks(rows.numel(), block)
        dalpha = torch.empty_like(alpha)
        dv = torch.zeros_like(v)
        r = torch.zeros((n, heads), dtype=alpha.dtype, device=alpha.device)
        for a, b in spans:
            d_i = dagg[rows[a:b]]
            torch.sum(d_i * v[cols[a:b]], -1, out=dalpha[a:b])
            dv.index_add_(0, cols[a:b], alpha[a:b, :, None] * d_i)
            r.index_add_(0, rows[a:b], alpha[a:b] * dalpha[a:b])
            del d_i
        del v, dagg
        keep(f"{pre}.lin_skip", dy, x)
        dx = dy @ mag(p[f"{pre}.lin_skip.weight"]) if i else None
        del dy
        for a, b in spans:  # the softmax's backward, into alpha: α·(dα ∓ Σ α·dα)/√d
            d = dalpha[a:b].add_(r[rows[a:b]]) if absolute else dalpha[a:b].sub_(r[rows[a:b]])
            alpha[a:b].mul_(d).mul_(1.0 / math.sqrt(head_dim))
        ds = alpha
        del dalpha, r, alpha
        dq, dk = torch.zeros_like(q), torch.zeros_like(k)
        for a, b in spans:
            dq.index_add_(0, rows[a:b], ds[a:b, :, None] * k[cols[a:b]])
            dk.index_add_(0, cols[a:b], ds[a:b, :, None] * q[rows[a:b]])
        del ds, q, k
        for lin, g in (("lin_query", dq), ("lin_key", dk), ("lin_value", dv)):
            g = g.view(n, width)
            keep(f"{pre}.{lin}", g, x)
            if dx is not None:
                dx.addmm_(g, mag(p[f"{pre}.{lin}.weight"]))
        del dq, dk, dv, g
        dy = dx
    return out


def train_step(indptr, indices, X, params, labels, train, *, heads: int, head_dim: int,
               dtype=torch.float64, block: int = 1 << 19) -> dict:
    """The loss, the logits and the gradient of the loss with respect to
    every parameter, by their closed form, on X's device, each computed in
    ``dtype`` and returned in float64: ``{"loss", "logits", "grads",
    "grad_scales"}``, the last two dicts by parameter name.  A scale is the
    sum of the absolute values of the terms of each element of a gradient,
    through the whole backward (the same backward on absolute values): the
    size its rounding is measured against, where the gradient itself may
    be a small difference of large terms."""
    layers = (len(params) - 2) // 8
    with torch.no_grad():
        p = {name: t.to(dtype) for name, t in params.items()}
        rows, cols = _edges(indptr, indices)
        xs = [X.to(dtype)]  # each layer's input, kept for its backward
        for i in range(layers):
            out = layer(xs[-1], rows, cols, p, f"layers.{i}", heads, head_dim, block)[0]
            xs.append(torch.relu(out) if i + 1 < layers else out)
            del out
        h = xs.pop()
        logits = _lin(h, p, "head")
        train = train.long()
        lt = logits[train].double()
        y = labels[train].long()
        ar = torch.arange(len(train), device=lt.device)
        loss = (torch.logsumexp(lt, 1) - lt[ar, y]).mean()
        prob = torch.softmax(logits[train], 1)
        dlog = torch.zeros_like(logits)
        hot = torch.zeros_like(prob)
        hot[ar, y] = 1
        dlog[train] = (prob - hot) / len(train)
        grads = _backward(xs, h, dlog, rows, cols, p, heads, head_dim, block, False)
        dlog[train] = (prob + hot) / len(train)
        scales = _backward(xs, h, dlog, rows, cols, p, heads, head_dim, block, True)
    return {"loss": loss.double(), "logits": logits.double(), "grads": grads, "grad_scales": scales}
