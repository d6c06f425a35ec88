"""Sparse attention over an ELL pack: the scores of a graph's edges from node
features (SDDMM), their softmax over each row, and the pack with those values
for ``ell_spmm`` -- the three steps of a graph-attention layer
(``nn/graph_attention.py``).

The pack ``E`` is the graph's pattern (``ell_pack`` of A with its values, 1
on every link): a slot of E is an edge where E's value is nonzero, and the
padding of the step-of-32 length classes, zero, is none.  Values computed on
E's slots travel as an ELL of E's structure (:func:`ell_with_values`) that
shares E's memo (K2's and K3's work tables, the transposed pack, the row
maps), so a step with new values builds no table: K2 re-points its memoized
table at them (``ops/ell_kernel.py: _repoint``).

- :func:`ell_sddmm`: ``S_ij = Q_i · K_j`` on E's edges, 0 on padding.  On
  CUDA tensors one launch of K3 (``csrc/ell_slab_sddmm.cu``) over the slabs,
  Q read through K2's row map; its backward is dQ = A(dS)·K by K2 with the
  row map and dK = A(dS)ᵀ·Q by K2 over the transposed pack -- two launches,
  no atomics.  CPU tensors take the kernels' plain versions.
- :func:`ell_edge_softmax`: ``α_ij = exp(c·S_ij - max_j c·S_ij) / Σ_j ...``
  over each row's edges, padding masked (α 0 there), its backward ``dS =
  c·α·(dα - Σ_j α·dα)``; per slab dense row reductions (no atomics), the
  same torch ops on every device.
- Rows longer than the pack's ``max_len`` (``E.rest``, a CSR) take plain
  gathers, a segment max and the ordered segment sum
  (``ops/segments.py``); their scores keep no gathered row for the
  backward (``_RestScores`` gathers again), the softmax is differentiated
  by autograd.

A row with no edge aggregates to zero (``ell_spmm`` fills the empty rows).
Spans: ``spmm.attn.scores``, ``.scores_bwd``, ``.softmax``, ``.softmax_bwd``;
counters below.
"""

from __future__ import annotations

import dataclasses
import types

import torch

from spmm_tpu_torch.formats.containers import as_tensor
from spmm_tpu_torch.formats.ell import ELL
from spmm_tpu_torch.ops import ell_kernel
from spmm_tpu_torch.ops.ell_kernel import (
    ell_slabs_sddmm,
    ell_slabs_spmm_mapped,
    ell_slabs_spmm_transposed,
    table_memo,
)
from spmm_tpu_torch.ops.ell_spmm import _row_maps, slab_row_keys
from spmm_tpu_torch.ops.segments import boundary_segments, offsets_plan, segment_sum
from spmm_tpu_torch.utils.profiling import span

#: CUDA launches in this process: K3 for the scores, and K2 (with the row map
#: or over the transposed pack) in the scores' backward
score_launches = 0
score_grad_launches = 0
#: edge softmax calls over a pack, forward and backward (torch ops, any device)
softmax_calls = 0
softmax_grad_calls = 0


def ell_with_values(E: ELL, data, rest_data=None) -> ELL:
    """E's structure with other values: ``data`` one tensor per slab, shaped
    as E's, and ``rest_data`` the leftover rows' values (E's own when None).
    It shares E's memo, so products over it reuse E's work tables."""
    V = dataclasses.replace(E, data=tuple(data),
                            rest=E.rest if rest_data is None else dataclasses.replace(E.rest, data=rest_data))
    memo = table_memo(E)
    if memo is not None:
        object.__setattr__(V, "_k2_tables", memo)
    return V


def _layout(E: ELL, device):
    """What the attention ops read of E on ``device``, memoized beside its
    work tables: each slab's padding mask (None for a slab with none), the
    rows that no slab row writes (empty and leftover), and for the leftover
    rows each entry's original row, its edge mask and the rows' segment
    plan."""
    memo = table_memo(E)
    key = ("attn", device)
    if memo is not None and key in memo:
        return memo[key]
    data = [as_tensor(d, device) for d in E.data]
    pad = [d == 0 for d in data]
    any_pad = torch.stack([p.any() for p in pad]).tolist() if pad else []
    pads = tuple(p if a else None for p, a in zip(pad, any_pad))
    _, rest_rows, zero_rows = _row_maps(E, device)
    lay = types.SimpleNamespace(pads=pads, other_rows=torch.cat([zero_rows, rest_rows]), rest=None)
    if E.n_rest_rows:
        R = E.rest.to(device)
        nnz = R.nnz
        row = boundary_segments(R.indptr, nnz, dtype=torch.int64, device=device)
        lay.rest = types.SimpleNamespace(
            nnz=nnz, nnz_pad=R.data.shape[0], cols=as_tensor(R.indices, device)[:nnz].long(),
            rows=rest_rows[row], row_ids=rest_rows, seg=row, live=as_tensor(R.data, device)[:nnz] != 0,
            plan=offsets_plan(as_tensor(R.indptr, device), device))
    if memo is not None:
        memo[key] = lay
    return lay


class _EllSddmm(torch.autograd.Function):
    """The slabs' scores by K3 (one output per slab, views of one array),
    padding zeroed; backward: dQ by K2 with the row map, dK by K2 over the
    transposed pack."""

    @staticmethod
    def forward(ctx, Q, K, call):
        global score_launches
        ctx.call = call
        ctx.save_for_backward(Q, K)
        before = ell_kernel.sddmm_launches
        S = ell_slabs_sddmm(call.cols, Q, K, memo=call.memo, row_keys=call.row_keys, out_rows=call.out_rows)
        score_launches += ell_kernel.sddmm_launches - before
        for s, pad in zip(S, call.pads):
            if pad is not None:
                s.masked_fill_(pad, 0)
        return S

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gS):
        global score_grad_launches
        Q, K = ctx.saved_tensors
        call = ctx.call
        with span("spmm.attn.scores_bwd"):
            g = [gs.contiguous() if pad is None else gs.masked_fill(pad, 0) for gs, pad in zip(gS, call.pads)]
            before = ell_kernel.launches
            dQ = dK = None
            if ctx.needs_input_grad[0]:
                dQ = ell_slabs_spmm_mapped(call.cols, g, K, call.out_rows, Q.shape[0], zero_rows=call.other_rows,
                                           memo=call.memo, row_keys=call.row_keys, accum_dtype=Q.dtype)
            if ctx.needs_input_grad[1]:
                dK = ell_slabs_spmm_transposed(call.cols, g, Q, K.shape[0], memo=call.memo,
                                               out_rows=call.out_rows)
            score_grad_launches += ell_kernel.launches - before
        return dQ, dK, None


class _RestScores(torch.autograd.Function):
    """The leftover rows' scores ``Q_row · K_col`` per entry (0 on padding),
    keeping Q and K for the backward and not the entries' gathered rows (an
    nnz × d pair a head): the backward gathers again.  dQ is each leftover
    row's ordered segment sum, written to its row once; dK an ``index_add_``
    over the columns."""

    @staticmethod
    def forward(ctx, Q, K, r):
        ctx.r = r
        ctx.save_for_backward(Q, K)
        s = (Q.index_select(0, r.rows) * K.index_select(0, r.cols)).sum(1) * r.live
        return torch.cat([s, s.new_zeros(r.nnz_pad - r.nnz)])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        Q, K = ctx.saved_tensors
        r = ctx.r
        g = (g[: r.nnz] * r.live)[:, None]
        dQ = dK = None
        if ctx.needs_input_grad[0]:
            per_row = segment_sum(g * K.index_select(0, r.cols), plan=r.plan)
            dQ = torch.zeros_like(Q).index_copy_(0, r.row_ids, per_row)
        if ctx.needs_input_grad[1]:
            dK = torch.zeros_like(K).index_add_(0, r.cols, g * Q.index_select(0, r.rows))
        return dQ, dK, None


def ell_sddmm(E: ELL, Q: torch.Tensor, K: torch.Tensor) -> ELL:
    """The ELL of E's structure with ``S_ij = Q_i · K_j`` on each edge (i, j)
    of E and 0 on padding, summed in Q's dtype (fp32 or fp64, Q and K
    alike), on Q's device; Q (m, d) and K (n, d), m and n E's shape.
    Differentiable with respect to Q and K.  On CUDA tensors the slabs are
    ONE launch of K3 and their backward two of K2; CPU tensors take the
    plain versions.  The leftover rows' scores are gathers."""
    dev = Q.device
    if Q.dim() != 2 or K.dim() != 2 or Q.shape[1] != K.shape[1] or Q.dtype != K.dtype:
        raise ValueError(f"ell_sddmm: Q {tuple(Q.shape)} {Q.dtype} and K {tuple(K.shape)} {K.dtype} "
                         "must be (m, d) and (n, d) of one dtype")
    if (Q.shape[0], K.shape[0]) != tuple(E.shape):
        raise ValueError(f"ell_sddmm: Q's and K's rows {(Q.shape[0], K.shape[0])} != E's shape {E.shape}")
    with span("spmm.attn.scores"):
        lay = _layout(E, dev)
        out_rows, _, _ = _row_maps(E, dev)
        call = types.SimpleNamespace(cols=E.cols, memo=table_memo(E), row_keys=lambda: slab_row_keys(E),
                                     out_rows=out_rows, pads=lay.pads, other_rows=lay.other_rows)
        Q, K = Q.contiguous(), K.contiguous()
        S = _EllSddmm.apply(Q, K, call) if E.cols else ()
        rest = None if lay.rest is None else _RestScores.apply(Q, K, lay.rest)
        return ell_with_values(E, S, rest)


class _EdgeSoftmax(torch.autograd.Function):
    """Softmax over each slab row (padding masked), one output per slab,
    views of one array; backward ``dS = c·α·(dα - Σ α·dα)``."""

    @staticmethod
    def forward(ctx, call, *S):
        global softmax_calls
        softmax_calls += 1
        sizes = [s.numel() for s in S]
        flat = S[0].new_empty(sum(sizes))
        A = tuple(a.view(s.shape) for a, s in zip(torch.split(flat, sizes), S))
        for s, a, pad in zip(S, A, call.pads):
            x = s if pad is None else s.masked_fill(pad, float("-inf"))
            m = x.amax(1, keepdim=True)
            if pad is not None:  # a row of padding alone gives 0, not NaN
                m.clamp_(min=torch.finfo(m.dtype).min)
            torch.sub(x, m, out=a)
            a.mul_(call.scale).exp_()
            den = a.sum(1, keepdim=True)
            if pad is not None:
                den.clamp_(min=torch.finfo(den.dtype).tiny)
            a.div_(den)
        ctx.call = call
        ctx.save_for_backward(*A)
        return A

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *dA):
        global softmax_grad_calls
        softmax_grad_calls += 1
        A = ctx.saved_tensors
        with span("spmm.attn.softmax_bwd"):
            sizes = [a.numel() for a in A]
            flat = A[0].new_empty(sum(sizes))
            dS = tuple(d.view(a.shape) for d, a in zip(torch.split(flat, sizes), A))
            for a, g, d in zip(A, dA, dS):
                torch.mul(a, g, out=d)
                r = d.sum(1, keepdim=True)
                torch.sub(g, r, out=d)
                d.mul_(a).mul_(ctx.call.scale)
        return (None, *dS)


def _rest_softmax(lay, s: torch.Tensor, scale: float) -> torch.Tensor:
    """The leftover rows' softmax over their edges (plain ops; autograd
    differentiates them): the max is a shift, taken without gradient."""
    r = lay.rest
    x = torch.where(r.live, s[: r.nnz] * scale, float("-inf"))
    m = torch.segment_reduce(x.detach(), "max", offsets=r.plan.offsets, axis=0)
    m = m.clamp(min=torch.finfo(m.dtype).min)
    e = torch.exp(x - m[r.seg])
    den = segment_sum(e, plan=r.plan).clamp(min=torch.finfo(e.dtype).tiny)
    a = e / den[r.seg]
    return torch.cat([a, a.new_zeros(r.nnz_pad - r.nnz)])


def ell_edge_softmax(E: ELL, S: ELL, *, scale: float = 1.0) -> ELL:
    """The ELL of E's structure with ``α_ij = softmax_j(scale · S_ij)`` over
    the edges of each row i of E (padding masked, 0 in α), from the values
    ``S`` on E's slots (:func:`ell_sddmm`'s result, or any ELL of E's
    structure).  ``scale`` > 0.  Differentiable with respect to S's values;
    the same torch ops on every device."""
    if not scale > 0:
        raise ValueError(f"ell_edge_softmax: scale must be > 0, got {scale}")
    if len(S.data) != len(E.data) or any(s.shape != e.shape for s, e in zip(S.data, E.data)):
        raise ValueError("ell_edge_softmax: S must have E's slabs")
    dev = (S.data[0] if S.data else S.rest.data).device
    with span("spmm.attn.softmax"):
        lay = _layout(E, dev)
        call = types.SimpleNamespace(pads=lay.pads, scale=float(scale))
        data = tuple(s.contiguous() for s in S.data)
        A = _EdgeSoftmax.apply(call, *data) if data else ()
        rest = None if lay.rest is None else _rest_softmax(lay, S.rest.data, float(scale))
        return ell_with_values(E, A, rest)
