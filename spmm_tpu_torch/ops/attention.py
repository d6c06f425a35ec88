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
- Rows longer than the pack's ``max_len`` (``E.rest``, a CSR) ride in the
  same launches as the slabs, cut into pieces of at most ``T_CUT`` entries
  (``ell_kernel.RestPieces``): K3 reads Q at each piece's row, K2 writes a
  cut row's pieces to scratch rows that one ordered sum joins, and the
  transposed pack holds the pieces' entries.  Their softmax runs on a
  (pieces × ≤ T_CUT) tile: a masked max and sum per piece, joined per row
  (the max by a segment max, the sums by the ordered segment sum), the
  backward's Σ α·dα by the same join.  Their values keep the CSR's order,
  reordered to the pieces' or the tile's by one scalar gather: no nnz × d
  tensor is made for them.

A row with no edge aggregates to zero (``ell_spmm`` fills the empty rows).
Spans: ``spmm.attn.scores``, ``.scores_bwd``, ``.softmax``, ``.softmax_bwd``;
counters below and ``ell_kernel.rest_piece_launches``.
"""

from __future__ import annotations

import dataclasses
import types

import torch

from spmm_tpu_torch.formats.containers import as_tensor
from spmm_tpu_torch.formats.ell import ELL
from spmm_tpu_torch.ops import ell_kernel
from spmm_tpu_torch.ops.ell_kernel import (
    _views,
    ell_slabs_sddmm,
    ell_slabs_spmm_mapped,
    ell_slabs_spmm_transposed,
    inverse_map,
    read_at,
    table_memo,
)
from spmm_tpu_torch.ops.ell_spmm import _row_maps, _slabs_of
from spmm_tpu_torch.ops.segments import offsets_plan, segment_sum
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
    as E's, and ``rest_data`` the leftover rows' values in their CSR's order
    (E's own when None).  It shares E's memo, so products over it reuse E's
    work tables."""
    V = dataclasses.replace(E, data=tuple(data),
                            rest=E.rest if rest_data is None else dataclasses.replace(E.rest, data=rest_data))
    memo = table_memo(E)
    if memo is not None:
        object.__setattr__(V, "_k2_tables", memo)
    return V


def _layout(E: ELL, device):
    """What the attention ops read of E on ``device``, memoized beside its
    work tables: the slabs K2 and K3 run over with their maps
    (``ell_spmm._slabs_of``: E's, or with leftover rows E's and their
    pieces), each pack slab's padding mask (None for a slab with none) and
    the empty rows; with leftover rows also the CSR entries that are
    padding in E (``dead``, None when there are none) and the softmax's tile
    (:func:`_tile`)."""
    memo = table_memo(E)
    key = ("attn", device)
    if memo is not None and key in memo:
        return memo[key]
    data = [as_tensor(d, device) for d in E.data]
    pad = [d == 0 for d in data]
    any_pad = torch.stack([p.any() for p in pad]).tolist() if pad else []
    lay = _slabs_of(E, device)
    lay.pads = tuple(p if a else None for p, a in zip(pad, any_pad))
    lay.zero_rows, lay.m, lay.dead, lay.tile = _row_maps(E, device)[2], E.shape[0], None, None
    if lay.pieces is not None:
        dead = as_tensor(E.rest.data, device) == 0
        if bool(dead[: E.rest.nnz].any()):
            lay.dead = dead
        lay.tile = _tile(lay.pieces, dead, device)
    if memo is not None:
        memo[key] = lay
    return lay


def _tile(P, dead: torch.Tensor, device):
    """The leftover rows' pieces as the rows of one (pieces × L) tile in row
    order, L the longest piece: ``src`` (int64, one per tile slot) the CSR
    entry each slot reads (``nnz_pad``, a zero appended, on padding), ``dst``
    each entry's slot, ``pad`` the slots that are no edge of E, ``row`` each
    piece's leftover row and ``plan`` each row's pieces, for the joins."""
    L = int(P.piece_len.max())
    start = torch.from_numpy(P.piece_start).to(device)
    pos = torch.arange(L, device=device)
    live = pos[None, :] < torch.from_numpy(P.piece_len).to(device)[:, None]
    src = torch.where(live, start[:, None] + pos[None, :], P.nnz_pad).reshape(-1)
    pad = torch.cat([dead, dead.new_ones(1)])[src].view(-1, L)
    return types.SimpleNamespace(src=src, dst=inverse_map(src, P.nnz_pad), pad=pad, shape=(P.count, L),
                                 row=torch.from_numpy(P.piece_row).to(device),
                                 plan=offsets_plan(P.piece_offsets, device))


class _EllSddmm(torch.autograd.Function):
    """The slabs' scores by K3 (one output per pack slab, views of one
    array), padding zeroed, and with leftover pieces the leftover entries'
    scores in their CSR's order; backward: dQ by K2 with the row map (the
    pieces' scratch rows joined), dK by K2 over the transposed pack."""

    @staticmethod
    def forward(ctx, Q, K, lay):
        global score_launches
        ctx.lay = lay
        ctx.save_for_backward(Q, K)
        before = ell_kernel.sddmm_launches
        S = ell_slabs_sddmm(lay.cols, Q, K, memo=lay.memo, row_keys=lay.row_keys, out_rows=lay.read_rows)
        score_launches += ell_kernel.sddmm_launches - before
        packs = len(lay.pads)
        for s, pad in zip(S, lay.pads):
            if pad is not None:
                s.masked_fill_(pad, 0)
        if lay.pieces is None:
            return S
        rest = lay.pieces.to_csr(S[packs:])
        if lay.dead is not None:
            rest.masked_fill_(lay.dead, 0)
        return (*S[:packs], rest)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gS):
        global score_grad_launches
        Q, K = ctx.saved_tensors
        lay = ctx.lay
        with span("spmm.attn.scores_bwd"):
            # every slab's gradient, padding zeroed, in one array: the
            # transposed product then reads it in place
            flat = gS[0].new_empty(sum(int(c.shape[0]) * int(c.shape[1]) for c in lay.cols))
            g = _views(flat, lay.cols)
            zero = flat.new_zeros(())
            for gs, pad, out in zip(gS, lay.pads, g):
                if pad is None:
                    out.copy_(gs)
                else:
                    torch.where(pad, zero, gs, out=out)
            if lay.pieces is not None:
                rest = gS[-1] if lay.dead is None else gS[-1].masked_fill(lay.dead, 0)
                flat[flat.shape[0] - lay.pieces.src.shape[0] :] = read_at(rest, lay.pieces.src)
            before = ell_kernel.launches
            dQ = dK = None
            if ctx.needs_input_grad[0]:
                dQ = ell_slabs_spmm_mapped(lay.cols, g, K, lay.write_rows, lay.m, zero_rows=lay.zero_rows,
                                           memo=lay.memo, row_keys=lay.row_keys, accum_dtype=Q.dtype,
                                           pieces=lay.pieces)
            if ctx.needs_input_grad[1]:
                dK = ell_slabs_spmm_transposed(lay.cols, g, Q, K.shape[0], memo=lay.memo,
                                               out_rows=lay.read_rows)
            score_grad_launches += ell_kernel.launches - before
        return dQ, dK, None


def ell_sddmm(E: ELL, Q: torch.Tensor, K: torch.Tensor) -> ELL:
    """The ELL of E's structure with ``S_ij = Q_i · K_j`` on each edge (i, j)
    of E and 0 on padding, summed in Q's dtype (fp32 or fp64, Q and K
    alike), on Q's device; Q (m, d) and K (n, d), m and n E's shape.
    Differentiable with respect to Q and K.  On CUDA tensors the slabs and
    the leftover rows' pieces are ONE launch of K3 and their backward two
    of K2; CPU tensors take the plain versions."""
    dev = Q.device
    if Q.dim() != 2 or K.dim() != 2 or Q.shape[1] != K.shape[1] or Q.dtype != K.dtype:
        raise ValueError(f"ell_sddmm: Q {tuple(Q.shape)} {Q.dtype} and K {tuple(K.shape)} {K.dtype} "
                         "must be (m, d) and (n, d) of one dtype")
    if (Q.shape[0], K.shape[0]) != tuple(E.shape):
        raise ValueError(f"ell_sddmm: Q's and K's rows {(Q.shape[0], K.shape[0])} != E's shape {E.shape}")
    with span("spmm.attn.scores"):
        lay = _layout(E, dev)
        Q, K = Q.contiguous(), K.contiguous()
        S = _EllSddmm.apply(Q, K, lay) if lay.cols else ()
        if lay.pieces is None:
            return ell_with_values(E, S)
        return ell_with_values(E, S[:-1], S[-1])


class _EdgeSoftmax(torch.autograd.Function):
    """Softmax over each slab row (padding masked), one output per slab,
    views of one array, and with leftover rows over each of them, its last
    input and output in the CSR's order; backward ``dS = c·α·(dα - Σ α·dα)``."""

    @staticmethod
    def forward(ctx, lay, scale, *S):
        global softmax_calls
        softmax_calls += 1
        packs = len(lay.pads)
        slabs = S[:packs]
        sizes = [s.numel() for s in slabs]
        flat = S[0].new_empty(sum(sizes))
        A = tuple(a.view(s.shape) for a, s in zip(torch.split(flat, sizes), slabs))
        for s, a, pad in zip(slabs, A, lay.pads):
            x = s if pad is None else s.masked_fill(pad, float("-inf"))
            m = x.amax(1, keepdim=True)
            if pad is not None:  # a row of padding alone gives 0, not NaN
                m.clamp_(min=torch.finfo(m.dtype).min)
            torch.sub(x, m, out=a)
            a.mul_(scale).exp_()
            den = a.sum(1, keepdim=True)
            if pad is not None:
                den.clamp_(min=torch.finfo(den.dtype).tiny)
            a.div_(den)
        ctx.lay, ctx.scale = lay, scale
        if lay.tile is None:
            ctx.save_for_backward(*A)
            return A
        a = _tile_softmax(lay.tile, S[packs], scale)
        ctx.save_for_backward(*A, a)
        return (*A, read_at(a, lay.tile.dst))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *dA):
        global softmax_grad_calls
        softmax_grad_calls += 1
        A = ctx.saved_tensors
        lay, scale = ctx.lay, ctx.scale
        with span("spmm.attn.softmax_bwd"):
            packs = len(lay.pads)
            sizes = [a.numel() for a in A[:packs]]
            flat = A[0].new_empty(sum(sizes))
            dS = tuple(d.view(a.shape) for d, a in zip(torch.split(flat, sizes), A))
            for a, g, d in zip(A, dA, dS):
                torch.mul(a, g, out=d)
                r = d.sum(1, keepdim=True)
                torch.sub(g, r, out=d)
                d.mul_(a).mul_(scale)
            if lay.tile is None:
                return (None, None, *dS)
            t, a = lay.tile, A[packs]
            d = read_at(dA[packs], t.src).view(a.shape)
            r = segment_sum((a * d).sum(1), plan=t.plan)
            d.sub_(r.index_select(0, t.row)[:, None]).mul_(a).mul_(scale)
            return (None, None, *dS, read_at(d, t.dst))


def _tile_softmax(t, s: torch.Tensor, scale: float) -> torch.Tensor:
    """α on the leftover rows' tile from their scores ``s`` in the CSR's
    order: per piece a masked max, the row's max the largest of its pieces'
    (a segment max over a few values a row), then per piece the sum of
    ``exp(scale·(s - max))``, the row's the ordered sum of its pieces'."""
    x = read_at(s, t.src).view(t.shape).masked_fill_(t.pad, float("-inf"))
    m = torch.segment_reduce(x.amax(1), "max", offsets=t.plan.offsets, axis=0)
    m.clamp_(min=torch.finfo(m.dtype).min)  # a row of padding alone gives 0, not NaN
    x.sub_(m.index_select(0, t.row)[:, None]).mul_(scale).exp_()
    den = segment_sum(x.sum(1), plan=t.plan).clamp_(min=torch.finfo(x.dtype).tiny)
    return x.div_(den.index_select(0, t.row)[:, None])


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
        data = tuple(s.contiguous() for s in S.data)
        if lay.tile is not None:
            data = (*data, as_tensor(S.rest.data, dev))
        A = _EdgeSoftmax.apply(lay, float(scale), *data) if data else ()
        if lay.tile is None:
            return ell_with_values(E, A)
        return ell_with_values(E, A[:-1], A[-1])
