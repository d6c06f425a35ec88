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

Two optional maps read inside K2: an output row per slab row
(:func:`ell_slabs_spmm_mapped`: ``ell_spmm`` writes every row of A at its
original row, with no un-permute after the launch) and a value index per
slot into one flat value array (the transposed pack reads A's values where
they are stored).  A memoized table holds its slabs' value pointers; called
with other value tensors of the same shapes (values computed anew each step,
as an attention layer's), it writes their pointers into its device copy with
one small asynchronous copy and keeps its structure (:func:`_repoint`).

Gradients.  The kernels launch through ctypes, which autograd cannot see, so
on CUDA tensors a product whose B or slab values require grad goes through a
``torch.autograd.Function``:

- grad B = Aᵀ · dY is K2 itself over the transposed slabs
  (:func:`transposed_slabs`, built once per pack at the first backward and
  memoized beside the work table).  It reads A's values through the value
  index (learnable values stay current) and writes each row of Aᵀ at its
  row of the gradient; rows of Aᵀ longer than ``T_CUT`` are cut into pieces
  (a web graph's in-degree hubs hold a quarter of its entries) that K2 sums
  apart into scratch rows and one ordered segment sum joins -- no atomics,
  so two backward runs give the same bits;
- grad data is K3, one launch over its own slot-major work table
  (:func:`sddmm_table`), memoized beside K2's.

The JAX package has no backward kernel (its gradients are XLA's transposes
of the gathers and sums); CPU tensors take the plain versions, which autograd
differentiates as they stand.

Leftover rows.  An ELL's rows longer than its pack's ``max_len`` (``E.rest``,
a CSR) are cut into pieces of at most ``T_CUT`` entries laid out as more
slabs (:class:`RestPieces`, built once per pack), which ride in the same K2
and K3 launches as the pack's: a read map names each piece's row for K3 and
the transposed pack, a write map sends a cut row's pieces to scratch rows
that one ordered segment sum joins, so those rows take no gathers of dense
rows and no atomics.

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
from spmm_tpu_torch.formats.containers import as_numpy, as_tensor, memo_of
from spmm_tpu_torch.formats.ell import _slab_plan
from spmm_tpu_torch.ops.segments import SegmentPlan, offsets_plan, segment_sum
from spmm_tpu_torch.utils.profiling import span

#: CUDA launches in this process (chip_smoke.py resets and reads them): K2 in
#: all, K2 over a transposed pack (the grad-B launches among them), and K3
launches = 0
transposed_launches = 0
sddmm_launches = 0
#: memoized K2 tables re-pointed at other value slabs (:func:`_repoint`)
repoints = 0
#: K2 and K3 launches (the transposed pack's among them) whose slabs carried
#: an ELL's leftover rows as pieces (:class:`RestPieces`)
rest_piece_launches = 0

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
#: rows of a transposed pack, and an ELL's leftover rows, longer than this
#: are cut into pieces of it
T_CUT = 2048
#: K3: slots a lane keeps in flight (a sub-batch) and steps per warp (the
#: kernel's kSub and kSteps); a warp step is 32 * max(1, K3_SUB // TPR) slots
K3_SUB = 8
K3_STEPS = 4


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


def k3_step(tpr_log2: int) -> int:
    """Slots one warp of K3 takes per step at ``2**tpr_log2`` lanes a row: 32
    (one per lane) times the ``K3_SUB // TPR`` units of a group narrower than
    ``K3_SUB`` lanes."""
    return 32 * max(1, K3_SUB >> tpr_log2)


def sddmm_table(shapes, tpr_log2: int, *, row_keys=None):
    """K3's work table for slabs of ``shapes`` [(R, L), ...] laid out one after
    another: slot-major, each CTA a run of ``THREADS // 32 * K3_STEPS *
    k3_step(tpr_log2)`` consecutive slots (slot = r * L + e) of one slab, its
    warps a run of ``K3_STEPS`` steps each.  Returns ``meta`` (S, 4) int64 (L,
    R, row offset, 0) and ``items`` (n_items, 2) int32 (slab, first slot),
    in the order of each item's first row's key when ``row_keys`` (one per
    row of the concatenated slabs) is given."""
    per_cta = THREADS // 32 * K3_STEPS * k3_step(tpr_log2)
    meta = np.zeros((len(shapes), 4), np.int64)
    item_slab, item_slot = [], []
    row0 = 0
    for s, (R, L) in enumerate(shapes):
        R, L = int(R), int(L)
        if R * L >= 2**31:
            raise ValueError(f"ell_slabs_sddmm: a slab of {R * L} slots (at most 2**31 - 1)")
        meta[s] = (L, R, row0, 0)
        starts = np.arange(0, R * L, per_cta, dtype=np.int64)
        item_slab.append(np.full(len(starts), s, np.int32))
        item_slot.append(starts)
        row0 += R
    if not shapes:
        return meta, np.zeros((0, 2), np.int32)
    slab = np.concatenate(item_slab)
    slot = np.concatenate(item_slot)
    items = np.stack([slab, slot.astype(np.int32)], 1)
    if row_keys is not None:
        first_row = meta[slab, 2] + slot // np.maximum(meta[slab, 0], 1)
        items = items[np.argsort(np.asarray(row_keys)[first_row], kind="stable")]
    return meta, np.ascontiguousarray(items, np.int32)


@dataclasses.dataclass(frozen=True)
class SlabTable:
    """The device form of one work table: the (S, 6) int64 slab table
    (pointers, then ``meta``), the items, each slab's offset in a flat
    per-slot array (K3's output), the slab tensors whose pointers it
    holds (kept alive with it) and the value slabs as the caller gave them
    (``src``: the same objects again need no new pointers)."""

    slabs: torch.Tensor
    items: torch.Tensor
    slot0: torch.Tensor
    data_code: int
    keep: tuple
    src: tuple = ()


def table_memo(owner) -> dict | None:
    """The dict on ``owner`` (an ELL, a slab view) that memoizes its work
    tables, keyed by device and lane layout, and its transposed pack
    (:func:`memo_of`)."""
    return memo_of(owner, "_k2_tables")


def _slab_table(cols, data, device, tpr_log2: int, row_keys=None, split_l: int = SPLIT_L,
                sddmm: bool = False) -> SlabTable:
    """``data`` None: a table without value pointers (K3 reads no value).
    ``data`` int32 slabs: value indices into a flat array that K2 is given
    at launch (its value dtype then comes with the launch).  ``sddmm``: K3's
    slot-major items (:func:`sddmm_table`) in place of K2's."""
    src = () if data is None else tuple(data)
    cols = [as_tensor(c, device) for c in cols]
    if data is not None:
        data = [as_tensor(d, device) for d in data]
        _data_code(data)
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
    shapes = [(c.shape[0], c.shape[1]) for c in cols]
    if sddmm:
        meta, items = sddmm_table(shapes, tpr_log2, row_keys=row_keys)
    else:
        meta, items = work_table(shapes, tpr_log2, row_keys=row_keys, split_l=split_l)
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
        data_code=_data_code(data) if data else kernels.F32,
        keep=(cols, data),
        src=src,
    )


def _data_code(data) -> int:
    """The kernels' dtype code of slab values (int32 value indices read as
    fp32: their launch names the value dtype); raises unless every slab has
    one dtype the kernels take."""
    dtypes = {d.dtype for d in data}
    if len(dtypes) > 1 or not dtypes <= {*_DTYPES, torch.int32}:
        raise TypeError(f"ell_slabs_spmm: slab data {sorted(map(str, dtypes))} not one dtype of "
                        "float32, bfloat16, float64")
    return _DTYPES.get(data[0].dtype, kernels.F32)


def _repoint(table: SlabTable, data, device) -> SlabTable:
    """``table`` over other value slabs of the same shapes: their pointers
    copied into the device table (from page-locked memory, without waiting:
    the copy is ordered on the stream before the next launch and after the
    last one that read the old pointers), the structure and items kept."""
    global repoints
    repoints += 1
    src = tuple(data)
    data = [as_tensor(d, device) for d in data]
    cols = table.keep[0]
    if len(data) != len(cols) or any(d.shape != c.shape or not d.is_contiguous() for d, c in zip(data, cols)):
        raise ValueError("ell_slabs_spmm: new slab values must be contiguous and shaped as the memoized slabs")
    code = _data_code(data) if data else kernels.F32
    ptrs = torch.tensor([d.data_ptr() for d in data], dtype=torch.int64)
    if device.type == "cuda":
        ptrs = ptrs.pin_memory()
    table.slabs[:, 1].copy_(ptrs, non_blocking=True)
    return dataclasses.replace(table, data_code=code, keep=(cols, tuple(data)), src=src)


def _table(cols, data, device, tpr_log2: int, memo, row_keys, sddmm: bool = False) -> SlabTable:
    """The work table of these slabs on ``device`` for one lane layout (K2's,
    or with ``sddmm`` K3's), from ``memo`` when it holds one; a memoized K2
    table given other value slabs than it points at is re-pointed
    (:func:`_repoint`)."""
    key = ("sddmm", device, tpr_log2) if sddmm else (device, tpr_log2)
    table = memo.get(key) if memo is not None else None
    if table is None:
        table = _slab_table(cols, data, device, tpr_log2, row_keys, sddmm=sddmm)
        if memo is not None:
            memo[key] = table
    elif data is not None and (len(data) != len(table.src) or any(a is not b for a, b in zip(data, table.src))):
        table = memo[key] = _repoint(table, data, torch.device(device))
    return table


def ell_slabs_spmm_reference(cols, data, B: torch.Tensor, out: torch.Tensor, *,
                             accum_dtype=None, out_rows=None, values=None) -> torch.Tensor:
    """The plain version of :func:`ell_slabs_spmm`: each slab's
    :func:`ell_slab_spmm_reference` into its rows of ``out``.  With K2's
    maps: ``out_rows`` (one per slab row) the row of ``out`` each slab row
    goes to, and ``values`` a flat array that ``data`` (int32 slabs) index,
    -1 reading zero."""
    row = 0
    if values is not None:
        flat = torch.cat([values.reshape(-1), values.new_zeros(1)])
    for c, d in zip(cols, data):
        c, d = as_tensor(c, B.device), as_tensor(d, B.device)
        if values is not None:
            d = flat[torch.where(d >= 0, d.long(), flat.shape[0] - 1)]
        y = ell_slab_spmm_reference(c, d, B, accum_dtype=accum_dtype)
        if out_rows is None:
            out[row : row + c.shape[0]] = y
        else:
            out[out_rows[row : row + c.shape[0]].long()] = y
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


def _k2_launch(cols, data, B: torch.Tensor, out: torch.Tensor, memo, row_keys, *,
               out_rows=None, values=None) -> torch.Tensor:
    """One launch of K2 into ``out`` (validated by the callers); with
    ``out_rows`` each slab row to its row of ``out``, with ``values`` the
    int32 ``data`` slabs index that flat array."""
    global launches, rest_piece_launches
    dev, k = B.device, B.shape[1]
    vec, tpr_log2 = lane_layout(k, B.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0,
                                _WIDE[B.dtype])
    table = _table(cols, data, dev, tpr_log2, memo, row_keys)
    if out.shape[0] == 0 or k == 0:
        return out
    launches += 1
    rest_piece_launches += _carries_pieces(memo)
    err = kernels.lib().ell_slabs_spmm_launch(
        table.slabs.data_ptr(), table.items.data_ptr(), table.items.shape[0],
        table.data_code if values is None else _DTYPES[values.dtype], B.data_ptr(),
        _DTYPES[B.dtype], out.data_ptr(), B.shape[0], k, vec, tpr_log2,
        None if out_rows is None else out_rows.data_ptr(),
        None if values is None else values.data_ptr(), kernels.stream_ptr(dev),
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
        call = types.SimpleNamespace(cols=cols, memo=memo, row_keys=row_keys, acc=acc, out_rows=None,
                                     pieces=None)
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


def ell_slabs_spmm_mapped(cols, data, B: torch.Tensor, out_rows: torch.Tensor, m: int, *,
                          zero_rows=None, memo: dict | None = None, row_keys=None, accum_dtype=None,
                          pieces: RestPieces | None = None) -> torch.Tensor:
    """(m, k): the slabs times B with K2's row map, slab row i written at
    row ``out_rows[i]`` (int32) and the rows ``zero_rows`` zero; together
    they cover every row once.  ``pieces``: the slabs are ``pieces.cols``,
    whose last ones are an ELL's leftover rows cut into pieces
    (:class:`RestPieces`): ``out_rows`` (its ``write_rows``) sends a cut
    row's pieces to scratch rows past m, which one ordered sum joins into
    the row, and the backward reads dY through its ``read_rows``.  CUDA
    tensors: ONE launch of K2 writing straight into the result and an
    ``index_fill_`` (recorded for autograd when B or a slab's values require
    grad: grad B then reads dY by these rows, with no gather).  CPU tensors
    take the plain version."""
    if B.dim() != 2:
        raise ValueError("ell_slabs_spmm_mapped: B must be (n, k)")
    dev, k = B.device, B.shape[1]
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ell_slabs_spmm_mapped: unsupported device {dev}")
    data = [as_tensor(d, dev) for d in data]
    acc = accum_of(data[0].dtype if data else B.dtype, accum_dtype)
    rows = sum(int(c.shape[0]) for c in cols)
    if out_rows.shape != (rows,) or out_rows.dtype != torch.int32 or out_rows.device != dev:
        raise ValueError(f"ell_slabs_spmm_mapped: out_rows must be ({rows},) int32 on {dev}")
    scratch = 0 if pieces is None else pieces.scratch
    if dev.type == "cpu":
        ys = ell_slabs_spmm_reference(cols, data, B, torch.empty((rows, k), dtype=acc), accum_dtype=acc)
        y = torch.zeros((m + scratch, k), dtype=acc).index_copy(0, out_rows.long(), ys)
        return y if pieces is None else _join(y, m, pieces.join_rows, pieces.join_plan)
    if data:
        _check_cuda_operands("ell_slabs_spmm_mapped", data[0].dtype, B, acc)
    call = types.SimpleNamespace(cols=cols, memo=memo, row_keys=row_keys, acc=acc, out_rows=out_rows,
                                 m=m, zero_rows=zero_rows, pieces=pieces)
    if grad_needed(B, *data):
        return _EllSlabsSpmm.apply(B, call, *data)
    return _mapped_forward(call, B, data)


def _join(y: torch.Tensor, m: int, rows: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """y's first m rows, each of ``rows`` the ordered sum of its pieces'
    scratch rows past m (``plan``: each row's, consecutive, in order);
    written in place on CUDA, recorded for autograd on the CPU."""
    if not rows.numel():
        return y[:m]
    joined = segment_sum(y[m:], plan=plan)
    if y.device.type == "cpu":
        return y[:m].index_copy(0, rows, joined)
    return y[:m].index_copy_(0, rows, joined)


def _mapped_forward(call, B, data) -> torch.Tensor:
    scratch = 0 if call.pieces is None else call.pieces.scratch
    y = torch.empty((call.m + scratch, B.shape[1]), dtype=call.acc, device=B.device)
    if call.zero_rows is not None and call.zero_rows.numel():
        y.index_fill_(0, call.zero_rows, 0)
    if call.cols:
        _k2_launch(call.cols, data, B, y, call.memo, call.row_keys, out_rows=call.out_rows)
    return y if call.pieces is None else _join(y, call.m, call.pieces.join_rows, call.pieces.join_plan)


class _EllSlabsSpmm(torch.autograd.Function):
    """K2 with its backward: grad B through K2 on the transposed slabs, grad
    data through K3; only what ``needs_input_grad`` asks for is computed.
    With a row map (``call.out_rows``) the product is the whole (m, k)
    result of :func:`ell_slabs_spmm_mapped`, dY read at the rows the slab
    rows were written to, or with leftover pieces at their ``read_rows``."""

    @staticmethod
    def forward(ctx, B, call, *data):
        ctx.call = call
        ctx.save_for_backward(B, *data)
        if call.out_rows is not None:
            return _mapped_forward(call, B, data)
        rows = sum(int(c.shape[0]) for c in call.cols)
        out = torch.empty((rows, B.shape[1]), dtype=call.acc, device=B.device)
        return _k2_launch(call.cols, data, B, out, call.memo, call.row_keys)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dY):
        B, *data = ctx.saved_tensors
        # the transposed pack's flat buffer may keep the values: without their
        # autograd nodes, whose contexts reach the memo (a cycle gc cannot free)
        data = [d.detach() for d in data]
        call = ctx.call
        dY = dY.contiguous()  # a slice's or an un-permute's backward hands over strided rows
        rows = call.out_rows if call.pieces is None else call.pieces.read_rows
        gB = None
        if ctx.needs_input_grad[0]:
            gB = ell_slabs_spmm_transposed(call.cols, data, dY, B.shape[0], memo=call.memo, out_rows=rows)
            gB = gB.to(B.dtype)
        gdata = [None] * len(data)
        if any(ctx.needs_input_grad[2:]):
            g = ell_slabs_sddmm(call.cols, dY, B, memo=call.memo, row_keys=call.row_keys, out_rows=rows)
            gdata = [gi.to(d.dtype) if need else None
                     for gi, d, need in zip(g, data, ctx.needs_input_grad[2:])]
        return (gB, None, *gdata)


# ---- the transposed pack: grad B = Aᵀ · dY as one more K2 launch -------------


@dataclasses.dataclass
class TransposedSlabs:
    """The slabs of Aᵀ for a list of slabs A (rows: A's clipped columns 0 ..
    n; columns: the rows of the concatenated slabs, or with the forward's row
    map the rows it wrote them to), structure only.

    ``cols[t]`` (R_t, L_t) int32 and ``vidx[t]`` (R_t, L_t) int32 -- the
    slot of A (in the slabs' concatenated, flattened order) whose value each
    slot of Aᵀ carries, or -1 for padding -- are all the structure: K2 reads
    the values of A's slabs through ``vidx`` on every call.  A row of Aᵀ
    with more than ``T_CUT`` entries is cut into pieces, each a slab row of
    its own.  ``out_rows`` (one per slab row, int32) is where K2 writes
    each: an uncut row of Aᵀ at its own row of the (n, k) result, a piece at
    a scratch row ``n + j``, a cut row's pieces at consecutive ones;
    ``hub_rows`` (H,) and ``hub_plan`` (each one's scratch rows) join them
    by the ordered segment sum, ``empty_rows`` are the rows of Aᵀ with no
    entry.  ``row_keys``: the row
    of Aᵀ of each slab row, the order K2 runs them in; ``memo`` keeps K2's
    work table over these slabs."""

    cols: tuple
    vidx: tuple
    out_rows: torch.Tensor
    n: int
    scratch: int
    empty_rows: torch.Tensor
    hub_rows: torch.Tensor
    hub_plan: SegmentPlan
    row_keys: np.ndarray
    memo: dict = dataclasses.field(default_factory=dict)
    #: per value dtype, the flat buffer A's values are copied into when they
    #: are held in more than one tensor, with the copy's sources and targets
    #: (:func:`flat_values`)
    bufs: dict = dataclasses.field(default_factory=dict)

    @property
    def rows(self) -> int:
        """Slab rows (pieces) of the pack."""
        return sum(int(c.shape[0]) for c in self.cols)

    @property
    def out_size(self) -> int:
        """Rows K2 writes into: the n rows of Aᵀ and the pieces' scratch rows."""
        return self.n + self.scratch


def transposed_slabs(cols, n: int, device, cut: int = T_CUT, out_rows=None) -> TransposedSlabs:
    """The transposed pack of the slabs with columns ``cols`` over n columns,
    on ``device``: the slots' (column, row) pairs are sorted by column there
    (every nnz-scale pass is a torch op), the n-scale slab plan is numpy on
    the host, as in ``ell_pack_device``.  Rows of Aᵀ longer than ``cut`` are
    cut into pieces of it.  ``out_rows``: the forward's row map (one row per
    slab row), which the pack's columns then name instead of slab rows."""
    cols = [as_tensor(c, device) for c in cols]
    row0 = np.cumsum([0] + [int(c.shape[0]) for c in cols])
    rows_all = torch.cat([
        (int(r0) + torch.arange(c.shape[0], device=device))[:, None].expand(c.shape).reshape(-1)
        for r0, c in zip(row0, cols)] or [torch.zeros(0, dtype=torch.int64, device=device)])
    cols_all = torch.cat([c.reshape(-1).long().clamp(0, n - 1) for c in cols]
                         or [torch.zeros(0, dtype=torch.int64, device=device)])
    order = torch.argsort(cols_all, stable=True)  # slots by row of Aᵀ, then by row of A
    t_cols = rows_all[order]
    if out_rows is not None:
        t_cols = as_tensor(out_rows, device).long()[t_cols]
    t_cols = t_cols.to(torch.int32)
    lens = torch.bincount(cols_all, minlength=n).cpu().numpy().astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(lens)])

    # one virtual row per piece of at most cut entries (none for an empty row)
    pieces = -(-lens // cut)
    piece0 = np.cumsum(pieces) - pieces
    v_row = np.repeat(np.arange(n, dtype=np.int64), pieces)
    v_j = np.arange(len(v_row), dtype=np.int64) - piece0[v_row]
    v_start = indptr[v_row] + v_j * cut
    v_len = np.minimum(cut, lens[v_row] - v_j * cut)
    perm, _, slabs, _ = _slab_plan(v_len, 64, 32, cut)

    ptr_s = torch.from_numpy(v_start[perm]).to(device)
    len_s = torch.from_numpy(v_len[perm]).to(device)
    t_slabs, vidx = [], []
    for L, lo, hi in slabs:
        pos = torch.arange(L, device=device)
        mask = pos[None, :] < len_s[lo:hi, None]
        src = torch.where(mask, ptr_s[lo:hi, None] + pos[None, :], 0)
        t_slabs.append(torch.where(mask, t_cols[src], 0).contiguous())
        vidx.append(torch.where(mask, order[src], -1).to(torch.int32).contiguous())

    # where each virtual row lands: an uncut row of Aᵀ at its own row, the
    # pieces of a cut row at scratch rows n, n + 1, ... in piece order
    hub = pieces > 1
    hub_rows = np.nonzero(hub)[0]
    cut_v = hub[v_row]
    dest = v_row.copy()
    P = int(cut_v.sum())
    dest[cut_v] = n + np.arange(P)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return TransposedSlabs(
        cols=tuple(t_slabs), vidx=tuple(vidx), out_rows=to_dev(dest[perm].astype(np.int32)),
        n=n, scratch=P, empty_rows=to_dev(np.nonzero(pieces == 0)[0]), hub_rows=to_dev(hub_rows),
        hub_plan=offsets_plan(np.concatenate([[0], np.cumsum(pieces[hub_rows])]), device), row_keys=v_row[perm],
    )


def _transposed_of(cols, n: int, device, memo, out_rows=None) -> TransposedSlabs:
    key = ("transposed", device, n) if out_rows is None else ("transposed", device, n, "rows")
    T = memo.get(key) if memo is not None else None
    if T is None:
        T = transposed_slabs(cols, n, device, out_rows=out_rows)
        if _carries_pieces(memo):
            T.memo[_PIECES] = True
        if memo is not None:
            memo[key] = T
    return T


def flat_values(data, bufs: dict | None = None) -> torch.Tensor:
    """The values of A's slabs in their concatenated, flattened slot order:
    what a transposed pack's ``vidx`` indexes.  One slab is its own flat
    view; several are copied into a buffer by one multi-tensor copy (a
    ``torch.cat`` of ~100 slabs of unequal sizes ran at a tenth of the
    card's copy rate).  ``bufs`` keeps, per dtype, the buffer and the
    copy's sources and targets while the same slab tensors come back (the
    values of a backward), so that a call costs the host one copy call, not
    one slice per slab."""
    if len(data) == 1:
        return data[0].reshape(-1)
    run = _one_run(data)
    if run is not None:
        return run
    ent = (bufs or {}).get(data[0].dtype)
    if ent is None or len(ent[1]) != len(data) or any(a is not b for a, b in zip(ent[1], data)):
        flats = [d.detach().reshape(-1) for d in data]
        buf = flats[0].new_empty(sum(f.numel() for f in flats))
        ent = (buf, tuple(data), list(torch.split(buf, [f.numel() for f in flats])), flats)
        if bufs is not None:
            bufs[data[0].dtype] = ent
    buf, _, targets, sources = ent
    torch._foreach_copy_(targets, sources)
    return buf


def _one_run(data) -> torch.Tensor | None:
    """The slabs as one flat view when they lie one after another in one
    storage (the views of one flat array, as K3 and the edge softmax give
    their slabs), else None."""
    first = data[0]
    base = first.untyped_storage().data_ptr()
    ptr = first.data_ptr()
    for d in data:
        if not d.is_contiguous() or d.dtype != first.dtype or d.untyped_storage().data_ptr() != base \
                or d.data_ptr() != ptr:
            return None
        ptr += d.numel() * d.element_size()
    return first.detach().as_strided(((ptr - first.data_ptr()) // first.element_size(),), (1,),
                                     first.storage_offset())


def _transposed_product(cols, data, dY: torch.Tensor, n: int, memo, product, out_rows=None) -> torch.Tensor:
    """Aᵀ · dY over the transposed pack: ``product(T, values, y)`` writes
    each slab row of the pack to its row ``T.out_rows`` of ``y``; the rows
    of Aᵀ with no entry are filled with zeros and the ordered segment sum
    joins the pieces of the cut rows."""
    dev = dY.device
    data = [d if isinstance(d, torch.Tensor) and d.device == dev else as_tensor(d, dev) for d in data]
    if not data or n == 0:
        return torch.zeros((n, dY.shape[1]), dtype=dY.dtype, device=dev)
    T = _transposed_of(cols, n, dev, memo, out_rows)
    y = torch.empty((T.out_size, dY.shape[1]), dtype=dY.dtype, device=dev)
    product(T, flat_values(data, T.bufs), y)
    if T.empty_rows.numel():
        y.index_fill_(0, T.empty_rows, 0)
    return _join(y, n, T.hub_rows, T.hub_plan)


def ell_slabs_spmm_transposed_reference(cols, data, dY: torch.Tensor, n: int, *,
                                        memo: dict | None = None, out_rows=None) -> torch.Tensor:
    """Plain PyTorch (n, k) = Aᵀ · dY: K2's plain version, with its maps, over
    the same transposed pack as :func:`ell_slabs_spmm_transposed`, on every
    device."""
    return _transposed_product(
        cols, data, dY, n, memo,
        lambda T, vals, y: ell_slabs_spmm_reference(T.cols, T.vidx, dY, y, accum_dtype=dY.dtype,
                                                    out_rows=T.out_rows, values=vals),
        out_rows)


def ell_slabs_spmm_transposed(cols, data, dY: torch.Tensor, n: int, *,
                              memo: dict | None = None, out_rows=None) -> torch.Tensor:
    """(n, k) = Aᵀ · dY for the slabs A = ``(cols, data)`` over n columns:
    the gradient of :func:`ell_slabs_spmm` with respect to B.  dY is (ΣR, k),
    or, with the forward's row map ``out_rows``, the (m, k) gradient of
    :func:`ell_slabs_spmm_mapped`, read at those rows.  On CUDA tensors ONE
    launch of K2 over the transposed pack (``memo`` keeps its structure),
    reading A's values through the pack's value index and writing each row
    of Aᵀ at its row of the result, then an index fill of the empty rows and
    the ordered segment sum that joins the pieces of the cut rows -- no
    atomics.  CPU tensors take the plain version."""
    with span("spmm.ell.transposed"):
        if dY.device.type == "cpu":
            return ell_slabs_spmm_transposed_reference(cols, data, dY, n, memo=memo, out_rows=out_rows)

        def launch(T, vals, y):
            global transposed_launches
            _check_cuda_operands("ell_slabs_spmm_transposed", vals.dtype, dY, dY.dtype)
            before = launches
            _k2_launch(T.cols, T.vidx, dY, y, T.memo, T.row_keys, out_rows=T.out_rows, values=vals)
            transposed_launches += launches - before

        return _transposed_product(cols, data, dY, n, memo, launch, out_rows)


# ---- an ELL's leftover rows as pieces on K2 and K3 -------------------------

#: the mark of a memo whose work tables carry leftover pieces (counted in
#: ``rest_piece_launches``)
_PIECES = "rest_pieces"


def _carries_pieces(memo) -> bool:
    return memo is not None and _PIECES in memo


@dataclasses.dataclass
class RestPieces:
    """An ELL's slabs followed by its leftover rows (``E.rest``: rows longer
    than the pack's ``max_len``, a CSR) cut into pieces of at most ``T_CUT``
    entries, laid out as more slabs by ``_slab_plan``'s classes (a last
    piece padded by < 32 slots): what K2 and K3 run over, so that those rows
    take no gathers of dense rows.  A derived device structure, like the
    transposed pack, built once per pack (:func:`rest_pieces`) and memoized
    beside its work tables; the ELL itself is unchanged.

    - ``cols``: the pack's slabs, then the last ``piece_slabs`` slabs of
      pieces ((R, L) int32, padding column 0);
    - ``read_rows`` (int32, one per slab row): its row of the m rows -- K3
      reads Q or dY there, and the transposed pack names Aᵀ's columns by it;
    - ``write_rows`` (int32): where K2 writes it: a pack row and the one
      piece of an uncut row at its row, the pieces of a cut row at scratch
      rows m, m + 1, ... in order; ``join_rows`` (int64) and ``join_plan``
      give each cut row the ordered sum of its scratch rows (written once, no
      atomics: two runs give the same bits);
    - ``src`` (int64, one per piece slot): the entry of the leftover CSR the
      slot carries, ``nnz_pad`` (a zero appended) on padding; ``dst`` (int64,
      one per CSR entry): its piece slot, past the slots for the CSR's
      padding.  Values on the leftover entries keep the CSR's order
      (``ell_with_values``' ``rest_data``); these two maps reorder them, one
      scalar an entry (:meth:`slabs`, :meth:`to_csr`);
    - ``piece_row``, ``piece_start``, ``piece_len`` (numpy, the pieces in row
      order): each piece's leftover row (0 .. n_rest), first CSR entry and
      length; ``piece_offsets`` (n_rest + 1): each row's pieces;
    - ``row_keys``: the order K2 and K3 run the slab rows in; ``memo``: their
      work tables and the transposed pack over these slabs."""

    cols: tuple
    piece_slabs: int
    read_rows: torch.Tensor
    write_rows: torch.Tensor
    m: int
    scratch: int
    join_rows: torch.Tensor
    join_plan: SegmentPlan
    src: torch.Tensor
    dst: torch.Tensor
    piece_row: np.ndarray
    piece_start: np.ndarray
    piece_len: np.ndarray
    piece_offsets: np.ndarray
    row_keys: np.ndarray
    memo: dict = dataclasses.field(default_factory=lambda: {_PIECES: True})

    @property
    def count(self) -> int:
        """The pieces: slab rows past the pack's."""
        return len(self.piece_row)

    @property
    def nnz_pad(self) -> int:
        return self.dst.shape[0]

    def slabs(self, values: torch.Tensor) -> tuple:
        """The leftover CSR's values (``nnz_pad`` of them, in its order) as
        the pieces' slabs, 0 on padding: views of one array.  One scalar
        gather; recorded for autograd (its backward the gather back)."""
        flat = _Reorder.apply(values, self.src, self.dst)
        return _views(flat, self.cols[len(self.cols) - self.piece_slabs :])

    def to_csr(self, slabs) -> torch.Tensor:
        """The pieces' slabs back in the CSR's order (0 on its padding)."""
        flat = _one_run(slabs)
        if flat is None:
            flat = torch.cat([d.reshape(-1) for d in slabs])
        return _Reorder.apply(flat, self.dst, self.src)


def _views(flat: torch.Tensor, cols) -> tuple:
    """``flat`` as slabs shaped as ``cols``, one after another."""
    sizes = [int(c.shape[0]) * int(c.shape[1]) for c in cols]
    return tuple(v.view(tuple(c.shape)) for v, c in zip(torch.split(flat, sizes), cols))


def read_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x``'s N values read at ``idx``, where N reads a zero: a reorder of
    one scalar an entry."""
    return torch.cat([x.reshape(-1), x.new_zeros(1)]).index_select(0, idx)


class _Reorder(torch.autograd.Function):
    """:func:`read_at` for autograd: each entry of x is read once at most, so
    the backward is the same read of the gradient at ``back`` (x's position
    in the result, or past its end): a gather both ways, no scatter."""

    @staticmethod
    def forward(ctx, x, idx, back):
        ctx.back = idx, back
        return read_at(x, idx)

    @staticmethod
    def backward(ctx, g):
        idx, back = ctx.back
        return _Reorder.apply(g, back, idx), None, None


def inverse_map(src: torch.Tensor, n: int) -> torch.Tensor:
    """For ``src`` (slots -> one of n entries, or n for padding, each entry
    read once at most): each entry's slot, ``len(src)`` for an entry no slot
    reads."""
    slots = src.shape[0]
    dst = torch.full((n,), slots, dtype=torch.int64, device=src.device)
    live = src < n
    dst[src[live]] = torch.arange(slots, device=src.device)[live]
    return dst


def rest_pieces(cols, out_rows: torch.Tensor, row_keys, rest, rest_rows, m: int, device,
                cut: int = T_CUT) -> RestPieces:
    """The slabs ``cols`` (a pack's, written at the rows ``out_rows`` and run
    in the order ``row_keys``, or a function that returns it) followed by the
    leftover rows ``rest`` (a CSR whose row i is row ``rest_rows[i]`` of m,
    each with an entry) cut into pieces of at most ``cut`` entries, on
    ``device``.  The n_rest-scale plan is numpy on the host; every nnz-scale
    pass is a torch op on ``device``."""
    indptr = as_numpy(rest.indptr).astype(np.int64)
    lens = np.diff(indptr)
    pieces = -(-lens // cut)
    offsets = np.concatenate([[0], np.cumsum(pieces)])
    p_row = np.repeat(np.arange(len(lens)), pieces)
    p_j = np.arange(len(p_row)) - offsets[p_row]
    p_start = indptr[p_row] + p_j * cut
    p_len = np.minimum(cut, lens[p_row] - p_j * cut)
    perm, _, slabs, _ = _slab_plan(p_len, 64, 32, cut)

    indices = as_tensor(rest.indices, device)
    nnz_pad = int(indices.shape[0])
    start_s = torch.from_numpy(p_start[perm]).to(device)
    len_s = torch.from_numpy(p_len[perm]).to(device)
    p_cols, p_src = [], []
    for L, lo, hi in slabs:
        pos = torch.arange(L, device=device)
        live = pos[None, :] < len_s[lo:hi, None]
        src = torch.where(live, start_s[lo:hi, None] + pos[None, :], nnz_pad)
        p_cols.append(torch.where(live, indices[src.clamp(max=nnz_pad - 1)], 0).to(torch.int32).contiguous())
        p_src.append(src.reshape(-1))
    src = torch.cat(p_src)

    # the row each piece is read at, and the one K2 writes it to: an uncut
    # row's at its own row, a cut row's at scratch rows m, m + 1, ... in order
    rows = as_numpy(rest_rows).astype(np.int64)
    orig = rows[p_row]
    cut_p = pieces[p_row] > 1
    dest = orig.copy()
    dest[cut_p] = m + np.arange(int(cut_p.sum()))
    out_rows = as_tensor(out_rows, device)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    if callable(row_keys):
        row_keys = row_keys()
    return RestPieces(
        cols=(*(as_tensor(c, device) for c in cols), *p_cols), piece_slabs=len(p_cols),
        read_rows=torch.cat([out_rows, to_dev(orig[perm])]), write_rows=torch.cat([out_rows, to_dev(dest[perm])]),
        m=m, scratch=int(cut_p.sum()), join_rows=torch.from_numpy(rows[pieces > 1]).to(device),
        join_plan=offsets_plan(np.concatenate([[0], np.cumsum(pieces[pieces > 1])]), device),
        src=src, dst=inverse_map(src, nnz_pad), piece_row=p_row, piece_start=p_start, piece_len=p_len,
        piece_offsets=offsets, row_keys=np.concatenate([np.asarray(row_keys, np.int64), orig[perm]]),
    )


# ---- K3: grad data, a sampled dense-dense product over the slabs' slots -------


def ell_slabs_sddmm_reference(cols, dY: torch.Tensor, B: torch.Tensor, *, out_rows=None) -> tuple:
    """Plain PyTorch ``dData_s[r, e] = Σ_j dY[row0_s + r, j] · B[clip(cols_s[r,
    e]), j]`` per slab, in dY's dtype; with K2's row map the dY row of slab
    row i is ``out_rows[i]``."""
    out, row = [], 0
    for c in cols:
        c = as_tensor(c, B.device).long().clamp(0, B.shape[0] - 1)
        if out_rows is None:
            y = dY[row : row + c.shape[0]]
        else:
            y = dY[out_rows[row : row + c.shape[0]].long()]
        out.append((y[:, None, :] * B[c].to(dY.dtype)).sum(2))
        row += c.shape[0]
    return tuple(out)


def ell_slabs_sddmm(cols, dY: torch.Tensor, B: torch.Tensor, *, memo: dict | None = None,
                    row_keys=None, out_rows=None) -> tuple:
    """The gradient of :func:`ell_slabs_spmm` with respect to the slab
    values: per slab an (R_s, L_s) tensor in dY's dtype (views of one flat
    array).  CPU tensors take the plain version; CUDA tensors ONE launch of
    K3 over its slot-major work table (:func:`sddmm_table`, kept in ``memo``
    beside K2's; ``row_keys`` orders its items as K2's).  dY is fp32 for an
    fp32 or bf16 B and fp64 for an fp64 B: (ΣR, k), or with K2's row map
    ``out_rows`` the (m, k) gradient read at those rows."""
    global sddmm_launches, rest_piece_launches
    with span("spmm.ell.sddmm"):
        dev, k = B.device, B.shape[1]
        if dev.type == "cpu":
            return ell_slabs_sddmm_reference(cols, dY, B, out_rows=out_rows)
        if dev.type != "cuda":
            raise ValueError(f"ell_slabs_sddmm: unsupported device {dev}")
        want = torch.float64 if B.dtype == torch.float64 else torch.float32
        if B.dtype not in _DTYPES or dY.dtype != want:
            raise TypeError(f"ell_slabs_sddmm: dY {dY.dtype} with B {B.dtype}: the kernel takes a "
                            "float32 dY with a float32 or bfloat16 B, or float64 for both")
        rows = sum(int(c.shape[0]) for c in cols)
        want_rows = rows if out_rows is None else dY.shape[0]
        if tuple(dY.shape) != (want_rows, k) or dY.device != dev:
            raise ValueError(f"ell_slabs_sddmm: dY {tuple(dY.shape)} on {dY.device} != {(want_rows, k)} on {dev}")
        if out_rows is not None and (out_rows.shape != (rows,) or out_rows.dtype != torch.int32):
            raise ValueError(f"ell_slabs_sddmm: out_rows must be ({rows},) int32")
        if not (B.is_contiguous() and dY.is_contiguous()) or B.shape[0] < 1 or k < 1:
            raise ValueError("ell_slabs_sddmm: B and dY must be contiguous, n >= 1 and k >= 1")
        vec, tpr_log2 = lane_layout(k, B.data_ptr() % 16 == 0 and dY.data_ptr() % 16 == 0,
                                    _WIDE[B.dtype])
        table = _table(cols, None, dev, tpr_log2, memo, row_keys, sddmm=True)
        shapes = [tuple(c.shape) for c in table.keep[0]]
        flat = torch.empty(sum(R * L for R, L in shapes), dtype=dY.dtype, device=dev)
        if flat.numel():
            sddmm_launches += 1
            rest_piece_launches += _carries_pieces(memo)
            err = kernels.lib().ell_slabs_sddmm_launch(
                table.slabs.data_ptr(), table.items.data_ptr(), table.items.shape[0],
                table.slot0.data_ptr(), dY.data_ptr(), B.data_ptr(), _DTYPES[B.dtype], flat.data_ptr(),
                B.shape[0], k, vec, tpr_log2, None if out_rows is None else out_rows.data_ptr(),
                kernels.stream_ptr(dev),
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
