"""K2 — ELL slabs times a dense matrix: the CUDA kernel
``csrc/ell_slab_spmm.cu``, its plain PyTorch version, its work table, and the
wrappers that pick between kernel and plain version by the tensors' device;
beside it K3, ``csrc/ell_slab_sddmm.cu``, the gradient with respect to the
slab values, and the transposed pack that gives the gradient with respect to
the dense operand as one more K2 launch.

``ell_slabs_spmm`` multiplies a list of slabs in one launch, slab s writing
rows ``row0_s .. row0_s + R_s`` of one output; ``ell_slab_spmm`` is the
one-slab call of the same kernel.  The launch follows a work table
(:func:`work_table`) built on the host once per pack and lane layout, and
memoized on the container that holds the slabs (:func:`table_memo`).

Gradients.  The kernels launch through ctypes, which autograd cannot see, so
on CUDA tensors a product whose B or slab values require grad goes through a
``torch.autograd.Function``:

- grad B = Aᵀ · dY is K2 itself over the transposed slabs
  (:func:`transposed_slabs`, built once per pack at the first backward and
  memoized beside the work table; the values are carried into it per call by
  one gather, so learnable values stay current).  Rows of Aᵀ longer than
  ``T_CUT`` are cut into pieces (a web graph's in-degree hubs hold a quarter
  of its entries) that K2 sums apart and one gather + sum joins -- no
  atomics, so two backward runs give the same bits;
- grad data is K3, one launch over the same slab table and work items.

The JAX package has no backward kernel (its gradients are XLA's transposes
of the gathers and sums); CPU tensors take the plain versions, which autograd
differentiates as they stand.

Types.  The sums are fp32 for fp32 / bf16 operands and fp64 for fp64 data
times an fp64 B (``accum_dtype``, by default the promotion of the data type
with fp32); the output has the accumulate type.  On CUDA any other mix
raises; the plain versions cast to ``accum_dtype`` as the JAX package does.

Replaces the Pallas TPU kernel ``spmm_tpu/ops/pallas_ell.py:
ell_slab_octets_pallas`` (reached by ``ell_slab_spmm_pallas``) and the XLA
per-slab sum of ``spmm_tpu/ops/ell_spmm.py: _slab_loop``.  The kernels'
headers say what bounds them on the card and how their designs answer that.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from spmm_tpu_torch import kernels
from spmm_tpu_torch.formats.containers import as_tensor, memo_of
from spmm_tpu_torch.formats.ell import _slab_plan

#: CUDA launches in this process (chip_smoke.py resets and reads them): K2 in
#: all, K2 over a transposed pack (the grad-B launches among them), and K3
launches = 0
transposed_launches = 0
sddmm_launches = 0

_DTYPES = {torch.float32: kernels.F32, torch.bfloat16: kernels.BF16, torch.float64: kernels.F64}
#: columns per lane in the wide lane layout: 16 bytes of fp32 or fp64, 8 of bf16
_WIDE = {torch.float32: 4, torch.bfloat16: 4, torch.float64: 2}

#: threads per CTA (the kernel's kThreads) and the most B-row loads it keeps
#: in flight per lane (its kUnroll at 2-8 lanes a row); a split
#: row's chunks are multiples of it
THREADS = 256
UNROLL = 8
#: rows longer than this are cut over the groups of one CTA (on the H100, 64
#: and 128 tie and 32 or no split are slower: the repo's sweep_k2.py, PERF.md)
SPLIT_L = 64
#: int64 fields per slab in the device table (the kernel's kSlabFields)
SLAB_FIELDS = 6
#: rows of a transposed pack longer than this are cut into pieces of it
T_CUT = 2048


def accum_of(data_dtype, accum_dtype=None):
    """The accumulate (and output) type: ``accum_dtype``, else the promotion
    of the data type with fp32 (bf16 and fp32 values sum in fp32, fp64 in
    fp64)."""
    return accum_dtype or torch.promote_types(data_dtype, torch.float32)


def ell_slab_spmm_reference(cols: torch.Tensor, data: torch.Tensor, B: torch.Tensor, *,
                            accum_dtype=None) -> torch.Tensor:
    """Plain PyTorch ``Y[r] = Σ_e data[r, e] · B[clip(cols[r, e]), :]`` in
    ``accum_dtype`` (:func:`accum_of`), for cols/data (R, L) and B (n, k)."""
    acc = accum_of(data.dtype, accum_dtype)
    c = cols.long().clamp(0, B.shape[0] - 1)
    return (data.to(acc)[..., None] * B[c].to(acc)).sum(1)


def lane_layout(k: int, aligned: bool, wide: int = 4) -> tuple[int, int]:
    """``(vec, tpr_log2)``: columns per lane (``wide`` -- 4, or 2 in fp64 --
    when k % wide == 0 and B and the output are 16-byte aligned, else 1) and
    log2 of the lanes that share one row (the smallest power of two covering
    k / vec, at most a warp)."""
    vec = wide if k % wide == 0 and aligned else 1
    units = max(k // vec, 1)
    tpr_log2 = 0
    while (1 << tpr_log2) < units and tpr_log2 < 5:
        tpr_log2 += 1
    return vec, tpr_log2


def work_table(shapes, tpr_log2: int, *, row_keys=None, split_l: int = SPLIT_L):
    """K2's work table for slabs of ``shapes`` [(R, L), ...] laid out one
    after another, for groups of ``2**tpr_log2`` lanes.  ``row_keys``: one
    key per row of the concatenated slabs (e.g. its row in the original
    matrix); items then run in the order of their first row's key, so that
    the CTAs in flight share B rows through L2.  Returns

    - ``meta`` (S, 4) int64: L, R, output row offset, ``chunk``.  A slab with
      L > ``split_l`` has ``chunk`` > 0: each of its rows is one item whose
      entries are cut into chunks of ``chunk`` over the CTA's groups (a
      multiple of the unroll, so each group's loads come in full batches).
      Otherwise ``chunk`` = 0 and an item is one row per group;
    - ``items`` (n_items, 2) int32: (slab, first row) per CTA, in key order,
      or slab by slab and row by row without keys.
    """
    groups = THREADS >> tpr_log2
    meta = np.zeros((len(shapes), 4), np.int64)
    item_slab, item_row = [], []
    row0 = 0
    for s, (R, L) in enumerate(shapes):
        R, L = int(R), int(L)
        if L > split_l:
            chunk = -(-L // groups)
            chunk = -(-chunk // UNROLL) * UNROLL
            starts = np.arange(R)
        else:
            chunk = 0
            starts = np.arange(0, R, groups)
        meta[s] = (L, R, row0, chunk)
        item_slab.append(np.full(len(starts), s, np.int32))
        item_row.append(starts.astype(np.int32))
        row0 += R
    if not shapes:
        return meta, np.zeros((0, 2), np.int32)
    items = np.stack([np.concatenate(item_slab), np.concatenate(item_row)], 1)
    if row_keys is not None:
        items = items[np.argsort(np.asarray(row_keys)[meta[items[:, 0], 2] + items[:, 1]], kind="stable")]
    return meta, np.ascontiguousarray(items, np.int32)


def table_slots(meta: np.ndarray, items: np.ndarray, tpr_log2: int):
    """The (slab, row, e) slots each work item covers, as the kernel walks
    them: arrays ``(item, slab, row, e, part)``, where ``part`` is the group
    whose partial sum holds the slot on a split row and -1 on a whole row."""
    groups = THREADS >> tpr_log2
    out = [[] for _ in range(5)]
    for i, (s, r0) in enumerate(items):
        L, R, _, chunk = (int(x) for x in meta[s])
        if chunk:
            e = np.arange(L)
            rows, part = np.full(L, r0), e // chunk
        else:
            rows = r0 + np.arange(groups)
            rows = rows[rows < R]
            rows, e = np.repeat(rows, L), np.tile(np.arange(L), len(rows))
            part = np.full(len(e), -1)
        for lst, a in zip(out, (np.full(len(e), i), np.full(len(e), s), rows, e, part)):
            lst.append(np.asarray(a, np.int64))
    return tuple(np.concatenate(a) if a else np.zeros(0, np.int64) for a in out)


@dataclasses.dataclass(frozen=True)
class SlabTable:
    """The device form of one work table: the (S, 6) int64 slab table
    (pointers, then ``meta``), the items, each slab's offset in a flat
    per-slot array (K3's output), and the slab tensors whose pointers it
    holds (kept alive with it)."""

    slabs: torch.Tensor
    items: torch.Tensor
    slot0: torch.Tensor
    data_code: int
    keep: tuple


def table_memo(owner) -> dict | None:
    """The dict on ``owner`` (an ELL, a slab view) that memoizes its work
    tables, keyed by device and lane layout, and its transposed pack
    (:func:`memo_of`)."""
    return memo_of(owner, "_k2_tables")


def _slab_table(cols, data, device, tpr_log2: int, row_keys=None, split_l: int = SPLIT_L) -> SlabTable:
    """``data`` None: a table without value pointers (K3 reads no value)."""
    cols = [as_tensor(c, device) for c in cols]
    if data is not None:
        data = [as_tensor(d, device) for d in data]
        dtypes = {d.dtype for d in data}
        if len(dtypes) > 1 or not dtypes <= set(_DTYPES):
            raise TypeError(f"ell_slabs_spmm: slab data {sorted(map(str, dtypes))} not one dtype of "
                            "float32, bfloat16, float64")
    for i, c in enumerate(cols):
        if c.dtype != torch.int32:
            raise TypeError(f"ell_slabs_spmm: cols must be int32, got {c.dtype}")
        if c.dim() != 2 or (data is not None and data[i].shape != c.shape):
            raise ValueError(f"ell_slabs_spmm: data {tuple(data[i].shape)} != cols {tuple(c.shape)}")
        if c.shape[1] < 1:
            raise ValueError("ell_slabs_spmm: needs L >= 1")
        if not (c.is_contiguous() and (data is None or data[i].is_contiguous())):
            raise ValueError("ell_slabs_spmm: slabs must be contiguous")
    if data is not None and len(data) != len(cols):
        raise ValueError(f"ell_slabs_spmm: {len(data)} data slabs for {len(cols)} cols slabs")
    if callable(row_keys):
        row_keys = row_keys()
    meta, items = work_table([(c.shape[0], c.shape[1]) for c in cols], tpr_log2, row_keys=row_keys,
                             split_l=split_l)
    host = np.zeros((len(cols), SLAB_FIELDS), np.int64)
    host[:, 0] = [c.data_ptr() for c in cols]
    if data is not None:
        host[:, 1] = [d.data_ptr() for d in data]
    host[:, 2:] = meta
    slots = meta[:, 0] * meta[:, 1]
    return SlabTable(
        slabs=torch.from_numpy(host).to(device),
        items=torch.from_numpy(items).to(device),
        slot0=torch.from_numpy(np.cumsum(slots) - slots).to(device),
        data_code=_DTYPES[data[0].dtype] if data else kernels.F32,
        keep=(cols, data),
    )


def _table(cols, data, device, tpr_log2: int, memo, row_keys) -> SlabTable:
    """The work table of these slabs on ``device`` for one lane layout, from
    ``memo`` when it holds one."""
    key = (device, tpr_log2)
    table = memo.get(key) if memo is not None else None
    if table is None:
        table = _slab_table(cols, data, device, tpr_log2, row_keys)
        if memo is not None:
            memo[key] = table
    return table


def ell_slabs_spmm_reference(cols, data, B: torch.Tensor, out: torch.Tensor, *,
                             accum_dtype=None) -> torch.Tensor:
    """The plain version of :func:`ell_slabs_spmm`: each slab's
    :func:`ell_slab_spmm_reference` into its rows of ``out``."""
    row = 0
    for c, d in zip(cols, data):
        c, d = as_tensor(c, B.device), as_tensor(d, B.device)
        out[row : row + c.shape[0]] = ell_slab_spmm_reference(c, d, B, accum_dtype=accum_dtype)
        row += c.shape[0]
    return out


def grad_needed(*tensors) -> bool:
    """Whether autograd is recording and one of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _check_cuda_operands(name: str, data_dtype, B: torch.Tensor, acc) -> None:
    ok32 = acc == torch.float32 and {data_dtype, B.dtype} <= {torch.float32, torch.bfloat16}
    ok64 = acc == data_dtype == B.dtype == torch.float64
    if not (ok32 or ok64):
        raise TypeError(
            f"{name}: slab data {data_dtype}, B {B.dtype}, accumulate {acc}: the kernel takes "
            "float32 or bfloat16 operands with a float32 accumulate, or float64 throughout "
            "(accum_dtype=torch.float64)")
    if not B.is_contiguous():
        raise ValueError(f"{name}: B must be contiguous")
    if B.shape[0] < 1:
        raise ValueError(f"{name}: needs n >= 1")


def _k2_launch(cols, data, B: torch.Tensor, out: torch.Tensor, memo, row_keys) -> torch.Tensor:
    """One launch of K2 into ``out`` (validated by the callers)."""
    global launches
    dev, k = B.device, B.shape[1]
    vec, tpr_log2 = lane_layout(k, B.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0,
                                _WIDE[B.dtype])
    table = _table(cols, data, dev, tpr_log2, memo, row_keys)
    if out.shape[0] == 0 or k == 0:
        return out
    launches += 1
    err = kernels.lib().ell_slabs_spmm_launch(
        table.slabs.data_ptr(), table.items.data_ptr(), table.items.shape[0], table.data_code,
        B.data_ptr(), _DTYPES[B.dtype], out.data_ptr(), B.shape[0], k, vec, tpr_log2,
        kernels.stream_ptr(dev),
    )
    kernels.check(err, "ell_slabs_spmm")
    return out


def ell_slabs_spmm(cols, data, B: torch.Tensor, out: torch.Tensor | None = None, *,
                   memo: dict | None = None, row_keys=None, accum_dtype=None) -> torch.Tensor:
    """(ΣR, k): the slabs ``(cols[s], data[s])`` (R_s, L_s) times B (n, k),
    slab s in rows ``Σ_{t<s} R_t ..`` of ``out`` (allocated when not given),
    in ``accum_dtype`` (:func:`accum_of`).  CPU tensors take the plain
    version; for CUDA tensors this is ONE launch of K2, and anything K2 does
    not take raises.  ``memo``: a dict (:func:`table_memo`) that keeps the
    work table (and, after a backward, the transposed pack) across calls on
    the same slabs, whose structure must then not change; slabs held
    elsewhere than B are copied to B's device once and kept with the table.
    ``row_keys``: the order of the work items (:func:`work_table`), or a
    function that returns it; read only when the table is built.

    When B or a slab's values require grad, the CUDA product is recorded for
    autograd (its backward: K2 over the transposed slabs, K3); it then
    returns its own tensor and ``out`` must be left out."""
    if B.dim() != 2:
        raise ValueError("ell_slabs_spmm: B must be (n, k)")
    dev, k = B.device, B.shape[1]
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ell_slabs_spmm: unsupported device {dev}")
    data_dtype = data[0].dtype if len(data) else B.dtype
    if not isinstance(data_dtype, torch.dtype):  # numpy slabs
        data_dtype = torch.from_numpy(np.empty(0, data_dtype)).dtype
    acc = accum_of(data_dtype, accum_dtype)
    if dev.type == "cuda":
        _check_cuda_operands("ell_slabs_spmm", data_dtype, B, acc)
    rows = sum(int(c.shape[0]) for c in cols)
    if out is not None and tuple(out.shape) != (rows, k):
        raise ValueError(f"ell_slabs_spmm: out {tuple(out.shape)} != {(rows, k)}")
    if dev.type == "cpu":
        if out is None:
            out = torch.empty((rows, k), dtype=acc, device=dev)
        return ell_slabs_spmm_reference(cols, data, B, out, accum_dtype=acc)
    if grad_needed(B, *data):
        if out is not None:
            raise ValueError("ell_slabs_spmm: a product that is recorded for autograd returns its "
                             "own tensor; leave out= out and place the result")
        call = types.SimpleNamespace(cols=cols, memo=memo, row_keys=row_keys, acc=acc)
        return _EllSlabsSpmm.apply(B, call, *(as_tensor(d, dev) for d in data))
    if out is None:
        out = torch.empty((rows, k), dtype=acc, device=dev)
    elif out.device != dev or out.dtype != acc or not out.is_contiguous():
        raise ValueError(f"ell_slabs_spmm: out must be a contiguous {acc} tensor on B's device")
    return _k2_launch(cols, data, B, out, memo, row_keys)


def ell_slabs_spmm_into(y: torch.Tensor, row0: int, cols, data, B: torch.Tensor, **kw) -> None:
    """The slab product into rows ``row0 .. row0 + ΣR`` of ``y``: written
    there by the kernel itself when no gradient is asked for (no copy), else
    by a recorded slice copy of the product's own tensor."""
    rows = sum(int(c.shape[0]) for c in cols)
    if B.device.type == "cuda" and grad_needed(B, *data):
        y[row0 : row0 + rows] = ell_slabs_spmm(cols, data, B, **kw)
    else:
        ell_slabs_spmm(cols, data, B, y[row0 : row0 + rows], **kw)


class _EllSlabsSpmm(torch.autograd.Function):
    """K2 with its backward: grad B through K2 on the transposed slabs, grad
    data through K3; only what ``needs_input_grad`` asks for is computed."""

    @staticmethod
    def forward(ctx, B, call, *data):
        rows = sum(int(c.shape[0]) for c in call.cols)
        out = torch.empty((rows, B.shape[1]), dtype=call.acc, device=B.device)
        ctx.call = call
        ctx.save_for_backward(B, *data)
        return _k2_launch(call.cols, data, B, out, call.memo, call.row_keys)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dY):
        B, *data = ctx.saved_tensors
        call = ctx.call
        dY = dY.contiguous()  # an un-permute's backward hands over strided rows
        gB = None
        if ctx.needs_input_grad[0]:
            gB = ell_slabs_spmm_transposed(call.cols, data, dY, B.shape[0], memo=call.memo)
            gB = gB.to(B.dtype)
        gdata = [None] * len(data)
        if any(ctx.needs_input_grad[2:]):
            g = ell_slabs_sddmm(call.cols, dY, B, data=data, memo=call.memo, row_keys=call.row_keys)
            gdata = [gi.to(d.dtype) if need else None
                     for gi, d, need in zip(g, data, ctx.needs_input_grad[2:])]
        return (gB, None, *gdata)


# ---- the transposed pack: grad B = Aᵀ · dY as one more K2 launch -------------


@dataclasses.dataclass
class TransposedSlabs:
    """The slabs of Aᵀ for a list of slabs A (rows: A's clipped columns 0 ..
    n; columns: the rows of the concatenated slabs), structure only.

    ``cols[t]`` (R_t, L_t) int32 and ``gather`` (Σ R_t·L_t,) int64 -- the
    slot of A (in the slabs' concatenated, flattened order) whose value each
    slot of Aᵀ carries, or ``nslots`` (a zero) for padding -- are all the
    structure; the values are gathered per call (:meth:`values`).  A row of
    Aᵀ with more than ``T_CUT`` entries is cut into pieces, each a slab row
    of its own: the product has one row per piece plus a last zero row, and
    ``first`` (n,), ``hub_rows`` (H,), ``hub_idx`` (H, J) join them
    (:func:`ell_slabs_spmm_transposed`).  ``row_keys``: the row of Aᵀ of each
    slab row, the order K2 runs them in."""

    cols: tuple
    gather: torch.Tensor
    nslots: int
    first: torch.Tensor
    hub_rows: torch.Tensor
    hub_idx: torch.Tensor
    row_keys: np.ndarray
    #: per value dtype: the persistent value buffer K2's table points into,
    #: and the dict that memoizes that table
    bufs: dict = dataclasses.field(default_factory=dict)

    @property
    def rows(self) -> int:
        """Slab rows (pieces) of the pack."""
        return sum(int(c.shape[0]) for c in self.cols)

    def values(self, data) -> tuple:
        """The values of ``data`` (A's slabs) in this pack's slots, one
        gather into a buffer kept per dtype (K2's table holds its address),
        as a tuple of (R_t, L_t) views of it; and that dtype's table memo."""
        flat = torch.cat([d.reshape(-1) for d in data] + [data[0].new_zeros(1)])
        if flat.dtype not in self.bufs:
            buf = torch.empty_like(self.gather, dtype=flat.dtype)
            views, off = [], 0
            for c in self.cols:
                views.append(buf[off : off + c.numel()].view(c.shape))
                off += c.numel()
            self.bufs[flat.dtype] = (buf, tuple(views), {})
        buf, views, memo = self.bufs[flat.dtype]
        torch.index_select(flat, 0, self.gather, out=buf)
        return views, memo


def transposed_slabs(cols, n: int, device, cut: int = T_CUT) -> TransposedSlabs:
    """The transposed pack of the slabs with columns ``cols`` over n columns,
    on ``device``: the slots' (column, row) pairs are sorted by column there
    (every nnz-scale pass is a torch op), the n-scale slab plan is numpy on
    the host, as in ``ell_pack_device``.  Rows of Aᵀ longer than ``cut`` are
    cut into pieces of it."""
    cols = [as_tensor(c, device) for c in cols]
    row0 = np.cumsum([0] + [int(c.shape[0]) for c in cols])
    rows_all = torch.cat([
        (int(r0) + torch.arange(c.shape[0], device=device))[:, None].expand(c.shape).reshape(-1)
        for r0, c in zip(row0, cols)] or [torch.zeros(0, dtype=torch.int64, device=device)])
    cols_all = torch.cat([c.reshape(-1).long().clamp(0, n - 1) for c in cols]
                         or [torch.zeros(0, dtype=torch.int64, device=device)])
    nslots = int(cols_all.numel())
    order = torch.argsort(cols_all, stable=True)  # slots by row of Aᵀ, then by row of A
    t_cols = rows_all[order].to(torch.int32)
    lens = torch.bincount(cols_all, minlength=n).cpu().numpy().astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(lens)])

    # one virtual row per piece of at most cut entries (none for an empty row)
    pieces = -(-lens // cut)
    piece0 = np.cumsum(pieces) - pieces
    v_row = np.repeat(np.arange(n, dtype=np.int64), pieces)
    v_j = np.arange(len(v_row), dtype=np.int64) - piece0[v_row]
    v_start = indptr[v_row] + v_j * cut
    v_len = np.minimum(cut, lens[v_row] - v_j * cut)
    V = len(v_row)
    perm, _, slabs, _ = _slab_plan(v_len, 64, 32, cut)
    inv = np.empty(V, np.int64)
    inv[perm] = np.arange(V)

    ptr_s = torch.from_numpy(v_start[perm]).to(device)
    len_s = torch.from_numpy(v_len[perm]).to(device)
    t_slabs, gathers = [], []
    for L, lo, hi in slabs:
        pos = torch.arange(L, device=device)
        mask = pos[None, :] < len_s[lo:hi, None]
        src = torch.where(mask, ptr_s[lo:hi, None] + pos[None, :], 0)
        t_slabs.append(torch.where(mask, t_cols[src], 0).contiguous())
        gathers.append(torch.where(mask, order[src], nslots).reshape(-1))

    first = np.full(n, V, np.int64)  # an empty row reads the zero row
    live = pieces > 0
    first[live] = inv[piece0[live]]
    hub_rows = np.nonzero(pieces > 1)[0]
    hub_idx = np.full((len(hub_rows), int(pieces.max()) if n else 0), V, np.int64)
    for h, i in enumerate(hub_rows):  # a few rows: the hubs
        hub_idx[h, : pieces[i]] = inv[piece0[i] : piece0[i] + pieces[i]]
    to_dev = lambda a: torch.from_numpy(a).to(device)
    return TransposedSlabs(
        cols=tuple(t_slabs),
        gather=torch.cat(gathers) if gathers else torch.zeros(0, dtype=torch.int64, device=device),
        nslots=nslots, first=to_dev(first), hub_rows=to_dev(hub_rows), hub_idx=to_dev(hub_idx),
        row_keys=v_row[perm],
    )


def _transposed_of(cols, n: int, device, memo) -> TransposedSlabs:
    key = ("transposed", device, n)
    T = memo.get(key) if memo is not None else None
    if T is None:
        T = transposed_slabs(cols, n, device)
        if memo is not None:
            memo[key] = T
    return T


def _transposed_product(cols, data, dY: torch.Tensor, n: int, memo, product) -> torch.Tensor:
    """Aᵀ · dY over the transposed pack: ``product(T, vals, t_memo, y)``
    fills one row of ``y`` per piece; a gather puts the rows in order and a
    gather + sum joins the pieces of the cut rows, in a fixed order."""
    dev = dY.device
    data = [as_tensor(d, dev) for d in data]
    if not data or n == 0:
        return torch.zeros((n, dY.shape[1]), dtype=dY.dtype, device=dev)
    T = _transposed_of(cols, n, dev, memo)
    vals, t_memo = T.values(data)
    V = T.rows
    y = torch.empty((V + 1, dY.shape[1]), dtype=dY.dtype, device=dev)
    y[V].zero_()
    product(T, vals, t_memo, y[:V])
    g = y.index_select(0, T.first)
    if T.hub_rows.numel():
        g[T.hub_rows] = y[T.hub_idx].sum(1)
    return g


def ell_slabs_spmm_transposed_reference(cols, data, dY: torch.Tensor, n: int, *,
                                        memo: dict | None = None) -> torch.Tensor:
    """Plain PyTorch (n, k) = Aᵀ · dY: K2's plain version over the same
    transposed pack as :func:`ell_slabs_spmm_transposed`, on every device."""
    return _transposed_product(
        cols, data, dY, n, memo,
        lambda T, vals, _, y: ell_slabs_spmm_reference(T.cols, vals, dY, y, accum_dtype=dY.dtype))


def ell_slabs_spmm_transposed(cols, data, dY: torch.Tensor, n: int, *,
                              memo: dict | None = None) -> torch.Tensor:
    """(n, k) = Aᵀ · dY for the slabs A = ``(cols, data)`` over n columns and
    dY (ΣR, k): the gradient of :func:`ell_slabs_spmm` with respect to B.  On
    CUDA tensors ONE launch of K2 over the transposed pack (``memo`` keeps
    its structure; the values are gathered from ``data`` on every call), then
    a gather that puts the rows in order and a gather + sum that joins the
    pieces of the cut rows -- no atomics.  CPU tensors take the plain
    version."""
    if dY.device.type == "cpu":
        return ell_slabs_spmm_transposed_reference(cols, data, dY, n, memo=memo)

    def launch(T, vals, t_memo, y):
        global transposed_launches
        _check_cuda_operands("ell_slabs_spmm_transposed", vals[0].dtype, dY, dY.dtype)
        before = launches
        _k2_launch(T.cols, vals, dY, y, t_memo, T.row_keys)
        transposed_launches += launches - before

    return _transposed_product(cols, data, dY, n, memo, launch)


# ---- K3: grad data, a sampled dense-dense product over the slabs' slots -------


def ell_slabs_sddmm_reference(cols, dY: torch.Tensor, B: torch.Tensor) -> tuple:
    """Plain PyTorch ``dData_s[r, e] = Σ_j dY[row0_s + r, j] · B[clip(cols_s[r,
    e]), j]`` per slab, in dY's dtype."""
    out, row = [], 0
    for c in cols:
        c = as_tensor(c, B.device).long().clamp(0, B.shape[0] - 1)
        y = dY[row : row + c.shape[0]]
        out.append((y[:, None, :] * B[c].to(dY.dtype)).sum(2))
        row += c.shape[0]
    return tuple(out)


def ell_slabs_sddmm(cols, dY: torch.Tensor, B: torch.Tensor, *, data=None,
                    memo: dict | None = None, row_keys=None) -> tuple:
    """The gradient of :func:`ell_slabs_spmm` with respect to the slab
    values: per slab an (R_s, L_s) tensor in dY's dtype (views of one flat
    array).  CPU tensors take the plain version; CUDA tensors ONE launch of
    K3 over K2's work table (``memo``, ``row_keys`` and ``data`` as K2's
    wrapper takes them: K3 reads no value, but a table built here is K2's
    too).  dY is fp32 for an fp32 or bf16 B and fp64 for an fp64 B."""
    global sddmm_launches
    dev, k = B.device, B.shape[1]
    if dev.type == "cpu":
        return ell_slabs_sddmm_reference(cols, dY, B)
    if dev.type != "cuda":
        raise ValueError(f"ell_slabs_sddmm: unsupported device {dev}")
    want = torch.float64 if B.dtype == torch.float64 else torch.float32
    if B.dtype not in _DTYPES or dY.dtype != want:
        raise TypeError(f"ell_slabs_sddmm: dY {dY.dtype} with B {B.dtype}: the kernel takes a "
                        "float32 dY with a float32 or bfloat16 B, or float64 for both")
    rows = sum(int(c.shape[0]) for c in cols)
    if tuple(dY.shape) != (rows, k) or dY.device != dev:
        raise ValueError(f"ell_slabs_sddmm: dY {tuple(dY.shape)} on {dY.device} != {(rows, k)} on {dev}")
    if not (B.is_contiguous() and dY.is_contiguous()) or B.shape[0] < 1 or k < 1:
        raise ValueError("ell_slabs_sddmm: B and dY must be contiguous, n >= 1 and k >= 1")
    vec, tpr_log2 = lane_layout(k, B.data_ptr() % 16 == 0 and dY.data_ptr() % 16 == 0,
                                _WIDE[B.dtype])
    if data is None:  # a table without value pointers is K3's alone
        memo = None
    table = _table(cols, data, dev, tpr_log2, memo, row_keys)
    shapes = [tuple(c.shape) for c in table.keep[0]]
    flat = torch.empty(sum(R * L for R, L in shapes), dtype=dY.dtype, device=dev)
    if flat.numel():
        sddmm_launches += 1
        err = kernels.lib().ell_slabs_sddmm_launch(
            table.slabs.data_ptr(), table.items.data_ptr(), table.items.shape[0],
            table.slot0.data_ptr(), dY.data_ptr(), B.data_ptr(), _DTYPES[B.dtype], flat.data_ptr(),
            B.shape[0], k, vec, tpr_log2, kernels.stream_ptr(dev),
        )
        kernels.check(err, "ell_slabs_sddmm")
    out, off = [], 0
    for R, L in shapes:
        out.append(flat[off : off + R * L].view(R, L))
        off += R * L
    return tuple(out)


def ell_slab_spmm(
    cols: torch.Tensor, data: torch.Tensor, B: torch.Tensor, *, out: torch.Tensor | None = None,
    accum_dtype=None,
) -> torch.Tensor:
    """Y (R, k) for one (R, L) slab, in ``accum_dtype`` (:func:`accum_of`);
    written into ``out`` (an (R, k) tensor of that type, e.g. a row range of
    the sorted output) when given.  The one-slab call of
    :func:`ell_slabs_spmm` (its work table is built per call)."""
    if cols.dim() != 2:
        raise ValueError("ell_slab_spmm: cols must be (R, L)")
    if B.device.type == "cuda":
        for name, t in (("cols", cols), ("data", data)):
            if t.device != B.device:
                raise ValueError(f"ell_slab_spmm: {name} on {t.device}, B on {B.device}")
    return ell_slabs_spmm((cols,), (data,), B, out, accum_dtype=accum_dtype)
