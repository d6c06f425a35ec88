"""Slab-sorted ESC SpGEMM (port of ``spmm_tpu/ops/slab_spgemm.py``).

C = A @ B without a global sort of the partial products:

1. **sizing** (host, O(nnz + nrow); ``_sizing_device`` for operands held in
   tensors): B's rows are cut into W-wide segments; a "pa" is one (A nonzero,
   B segment) pair.  Each A row's padded expansion is W times its pa count,
   and puts the row in one of ``DEFAULT_CLASSES`` (~1.25× steps).
2. **plan** (``spgemm_plan``, device): the B2 table — B's rows padded to W-wide
   segments, (nsegB_pad, W) int32 columns with ``_INT_MAX`` pads plus a value
   table of the same shape — the pa list in A-row order, and the rows sorted
   by class.  The pa order already groups the partial products by output
   row: that grouping is all ESC's global sort is for.  With ``expand=True``
   every class chunk's (R_pad, L) slab of partial products is gathered once
   into the class-aligned cache.
3. **numeric**: per class chunk, a row sort of the slab and a deterministic
   merge of duplicate columns, no atomics.  On the card K4
   (``csrc/slab_spgemm.cu``, ``ops/slab_kernel.py``) fetches and merges every
   chunk of a product in one pass (``chunk_merge_all``), merges the cached
   slabs (``slab_merge_all``), one launch per block-size group each, or
   writes every chunk's slab for the cache (``chunk_fetch_all``, one launch
   per plan), summing each run
   directly in slot order; the plain versions (CPU tensors) take differences
   of compacted inclusive prefix sums (run lengths in pattern mode).
4. **compaction** (``compact_to_csr``, K5 on the card): the chunks' unique
   columns go to a device CSR; only its arrays cross to the host.

Rows whose padded expansion exceeds the largest class go to the global-sort
ESC (``ops/spgemm.py``).  Products whose padded expansion exceeds
``_MAX_EXP_PAD`` run as uniform row pieces (``spgemm_slab_big``) with
piece-granular checkpoint/resume.

The JAX package's layouts for the TPU's (8, 128) tiling — folded 128-lane
tables, bit-cast value channels, set-scatter step functions, windowed
extracts — are not carried over: B2 is a plain (nsegB_pad, W) table, the pa
list a ``searchsorted`` expansion.  The sizing and the tables are torch ops
(and host numpy); the numeric phase and the compaction are K4 and K5 on CUDA
tensors, their plain versions on CPU tensors.  Sizes, classes and the chunk
schedule are the JAX package's, so both give the same chunks.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import warnings
import weakref
import zipfile
from typing import Any, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from spmm_tpu_torch import native
from spmm_tpu_torch.formats.containers import (
    COO, CSR, Container, as_numpy, compute_device, to_coo, to_csr,
)
from spmm_tpu_torch.ops.slab_kernel import (  # noqa: F401  (the plain versions keep their names here)
    _INT_MAX, _chunk_fetch, _chunk_meta, _compact_to_csr, _merge_block, _torch_dtype, check_class_limit,
    chunk_fetch, chunk_fetch_all, chunk_merge_all, compact_to_csr, slab_merge_all,
)
from spmm_tpu_torch.ops.spgemm import spgemm_sorted
from spmm_tpu_torch.ops.transform import _stable_argsort_smallint

Array = Any

#: padded-expansion bound of one product (or one piece of the big path): it
#: keeps every pa and slab index in int32 and bounds the plan tables and slab
#: temporaries (PERF.md gives the card's peak bytes per padded slot).
#: ``spgemm_slab`` cuts A's rows into pieces when a product exceeds it
#: (patchable in tests).
_MAX_EXP_PAD = 2**28

#: padded-expansion classes (~1.25× steps); rows above the last go to the
#: global-sort fallback
DEFAULT_CLASSES = (
    4, 8, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96, 128, 160, 192, 256, 320,
    384, 512, 640, 768, 1024, 1280, 1536, 2048, 2560, 3072, 4096, 5120, 6144,
    8192,
)

#: B-segment width: one pa fetches W columns of one B row
DEFAULT_SEG_W = 8

#: slab slots (R_pad * L) per chunk
DEFAULT_SLOT_BUDGET = 1 << 24

#: classes with fewer rows than this fold into the next class up
FOLD_THRESHOLD = 256

#: ``spgemm_slab`` compacts to CSR on the device while the padded expansion
#: stays under this (the compaction scratch is ~8 B per slot); past it the
#: chunks are pulled one by one and assembled on the host
_CSR_COMPACT_MAX = 1 << 26


def _bucket_pow2(x: int, floor: int = 8) -> int:
    b = floor
    while b < x:
        b <<= 1
    return b


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def _nseg_pad(nsegB: int) -> int:
    """Padded B2 segment count, with >= 1 never-written pad segment: the LAST
    segment is all ``_INT_MAX``, and masked chunk blocks and pa entries past
    ``npa`` read it, so their columns are pads without a select."""
    return _round_up(nsegB + 1, 1024)


def _norm_classes(classes, W: int) -> Tuple[int, ...]:
    """Padded expansions are multiples of W, so class bounds must be too."""
    return tuple(sorted({_round_up(c, W) for c in classes}))


def _max_chunk(classes, slot_budget: int) -> int:
    """Most rows a chunk can span: rows_sorted and rowmeta are padded by this,
    so no chunk's slice runs past their end."""
    return _bucket_pow2(max(slot_budget // classes[0], 8))


def _dtype_name(dt) -> str:
    return str(_torch_dtype(dt)).removeprefix("torch.")


def _device(A: CSR, device) -> torch.device:
    """``device`` when given, else where A's tensors lie; numpy-held operands
    go to ``cuda`` (:func:`compute_device` raises without one)."""
    if device is None and isinstance(A.data, torch.Tensor):
        return A.data.device
    return compute_device("cuda" if device is None else device)


class _ExpansionTooLarge(ValueError):
    """Padded expansion exceeds ``_MAX_EXP_PAD``.  ``spgemm_slab`` catches it
    and runs the product in pieces (``spgemm_slab_big``); from the lower-level
    entry points it propagates as a ValueError naming that remedy.  Args:
    (padded slots, padded slots of the rows below the class ceiling)."""

    def __str__(self):
        return (
            f"padded expansion {self.args[0]} slots exceeds the per-product "
            f"budget ({_MAX_EXP_PAD}); use spgemm_slab() (it pieces the "
            "product through spgemm_slab_big) or shard A first"
        )


# ---------------------------------------------------------------------------
# sizing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Sizing:
    """Sizing result.  Iterates as the 4-tuple (npa, nsegB, cls, counts)."""

    npa: int
    nsegB: int
    cls: Any  #: (nrow,) int32 per-row class: numpy (host sizing) or a tensor
    counts: tuple  #: rows per class, then the tail count (len(classes) + 1)
    #: (nrow,) int32 rows in stable class order (host sizing only)
    rows_sorted: np.ndarray | None = None

    def __iter__(self):
        return iter((self.npa, self.nsegB, self.cls, self.counts))


def _fold_small_classes(counts: np.ndarray, nclasses: int):
    """Fold classes holding fewer than FOLD_THRESHOLD rows into the next
    class up (a tiny chunk costs a whole chunk's launches; the padding grows
    by at most count * L_next).  Returns (counts, remap: raw → folded class)."""
    counts = np.asarray(counts, np.int64).copy()
    remap = np.arange(nclasses + 2, dtype=np.int32)
    for ci in range(nclasses - 1):
        if 0 < counts[ci] < FOLD_THRESHOLD:
            counts[ci + 1] += counts[ci]
            counts[ci] = 0
            remap[remap == ci] = ci + 1
    return counts, remap


def _tail_pairs(a_iptr, a_ind, cls, tail: int, nseg_row) -> int:
    """(A nonzero × B segment) pairs of the rows of class ``tail`` (above the
    class ceiling: they take the global-sort ESC), over those rows alone."""
    trows = np.nonzero(cls == tail)[0]
    tl = a_iptr[trows + 1] - a_iptr[trows]
    tpos = np.repeat(a_iptr[trows] - np.cumsum(tl) + tl, tl) + np.arange(tl.sum())
    return int(nseg_row[np.asarray(a_ind)[tpos].astype(np.int64)].sum())


def _sizing(A: CSR, B: CSR, W: int, classes) -> Sizing:
    """O(nnz + nrow) host sizing: (npa, nsegB, per-row class, counts) and the
    class permutation.  Native C++ pass, numpy without the native library.
    Operands held in tensors go to :func:`_sizing_device`."""
    if not isinstance(A.data, np.ndarray) or not isinstance(B.data, np.ndarray):
        return _sizing_device(A, B, W, classes)
    a_iptr = np.asarray(A.indptr, np.int64)
    a_ind = np.asarray(A.indices[: A.nnz])
    b_iptr = np.asarray(B.indptr, np.int64)
    classes_np = np.asarray(classes, np.int64)
    res = native.spgemm_sizing(a_iptr, a_ind, b_iptr, W, classes_np)
    if res is not None:
        npa, nsegB, cls = res
    else:
        lenB = b_iptr[1:] - b_iptr[:-1]
        nsegB = int(((lenB + W - 1) // W).sum())
        nseg_a = (lenB[a_ind.astype(np.int64)] + W - 1) // W
        npa = int(nseg_a.sum())
        segc = np.zeros(A.nnz + 1, dtype=np.int64)
        np.cumsum(nseg_a, out=segc[1:])
        exp_pad_row = W * (segc[np.minimum(a_iptr[1:], A.nnz)] - segc[np.minimum(a_iptr[:-1], A.nnz)])
        cls = np.searchsorted(classes_np, exp_pad_row, side="left").astype(np.int32)
        cls[exp_pad_row == 0] = len(classes) + 1
    if npa * W >= _MAX_EXP_PAD:
        nseg_row = (b_iptr[1:] - b_iptr[:-1] + W - 1) // W
        tail = _tail_pairs(a_iptr, a_ind, cls, len(classes), nseg_row)
        raise _ExpansionTooLarge(npa * W, (npa - tail) * W)
    counts, remap = _fold_small_classes(np.bincount(cls, minlength=len(classes) + 2), len(classes))
    cls = remap[cls]
    rows_sorted = native.counting_argsort_i32(cls, len(classes) + 2)
    if rows_sorted is None:
        rows_sorted = np.argsort(cls, kind="stable").astype(np.int32)
    return Sizing(
        npa=npa,
        nsegB=nsegB,
        cls=cls,
        counts=tuple(int(c) for c in counts[: len(classes) + 1]),
        rows_sorted=rows_sorted,
    )


def _sizing_device(A: CSR, B: CSR, W: int, classes) -> Sizing:
    """Sizing of operands held in tensors, on their device: the per-row class
    stays there and only (npa, nsegB, counts) come to the host (one copy of
    ~35 integers), so a chained product ``spgemm_slab_csr(C, X)`` moves no
    nnz-scale array.  Sums are int64, so no int32 overflow can hide."""
    dev = A.data.device
    a_iptr = torch.as_tensor(A.indptr, device=dev).long()
    a_ind = torch.as_tensor(A.indices, device=dev).long()
    b_iptr = torch.as_tensor(B.indptr, device=dev).long()
    nclasses = len(classes)
    lenB = b_iptr[1:] - b_iptr[:-1]
    nsegB_row = (lenB + (W - 1)) // W
    live = torch.arange(a_ind.shape[0], device=dev) < A.nnz
    nseg_a = torch.where(live, nsegB_row[a_ind.clamp(0, lenB.shape[0] - 1)], 0)
    seg_c = torch.cat([nseg_a.new_zeros(1), torch.cumsum(nseg_a, 0)])
    iptr = a_iptr.clamp(0, a_ind.shape[0])
    exp_pad_row = W * (seg_c[iptr[1:]] - seg_c[iptr[:-1]])
    classes_t = torch.tensor(classes, dtype=torch.int64, device=dev)
    cls = torch.searchsorted(classes_t, exp_pad_row, side="left")
    cls = torch.where(exp_pad_row == 0, nclasses + 1, cls)
    counts = torch.bincount(cls, minlength=nclasses + 2)
    head = torch.cat([seg_c[-1:], nsegB_row.sum().view(1), counts]).cpu().numpy()
    npa, nsegB = int(head[0]), int(head[1])
    if npa * W >= _MAX_EXP_PAD:
        raise _ExpansionTooLarge(npa * W, int(exp_pad_row[cls < nclasses].sum()))
    counts, remap = _fold_small_classes(head[2:], nclasses)
    cls = torch.from_numpy(remap).to(dev)[cls]
    return Sizing(
        npa=npa,
        nsegB=nsegB,
        cls=cls,
        counts=tuple(int(c) for c in counts[: nclasses + 1]),
    )


def _chunk_schedule(classes, counts, slot_budget):
    """(L, R_pad, start, count) per chunk from the class counts, and the
    offset of the tail rows in rows_sorted.  R_pad rounds to 1K-row granules
    (powers of two below) to bound the slab padding."""
    sched = []
    offset = 0
    for ci, L in enumerate(classes):
        n = int(counts[ci])
        rows_per_chunk = max(slot_budget // L, 8)
        for lo in range(0, n, rows_per_chunk):
            cnt = min(rows_per_chunk, n - lo)
            R_pad = min(_bucket_pow2(cnt), _round_up(cnt, 1 << 10))
            sched.append((L, R_pad, offset + lo, cnt))
        offset += n
    return sched, offset


def attainable_kwargs(sizing: Sizing, nrow_b: int, out_nnz: int, classes, *, W: int = DEFAULT_SEG_W,
                      slot_budget: int = DEFAULT_SLOT_BUDGET) -> dict:
    """The port's keyword arguments of ``ops.roofline.spgemm_attainable``
    for a product of this sizing (``spgemm_warm_attainable`` takes its
    ``chunk_slots``): the B2 table is (nsegB_pad, W) int32, so W*4-byte
    rows; ``_plan_tables``' per-row segment counts are int64, 8-byte rows;
    the chunks' (L, slots) are those of the schedule the product runs."""
    sched, _ = _chunk_schedule(classes, sizing.counts, slot_budget)
    return dict(nrow_b=nrow_b, b2_table_bytes=_nseg_pad(sizing.nsegB) * W * 4, b2_row_bytes=W * 4,
                geom_table_bytes=nrow_b * 8, geom_row_bytes=8, out_nnz=out_nnz,
                chunk_slots=tuple((L, R_pad * L) for L, R_pad, _, _ in sched))


def _is_pattern(M: CSR) -> bool:
    """True when every stored value is exactly 1.0 — the reference's forced
    semantics (serial_newblock_clock.cpp:84,96).  An O(nnz) host check;
    values held in tensors are not pulled to the host for it, so the answer
    there is False (callers that know pass ``pattern=True``)."""
    d = M.data
    if not isinstance(d, np.ndarray):
        return False
    return bool(np.all(d[: M.nnz] == 1))


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


class _Tables(NamedTuple):
    """The device tables of one product: see :class:`SpgemmPlan`."""

    b2_cols: torch.Tensor
    b2_vals: torch.Tensor
    pa_b2row: torch.Tensor
    pa_aval: torch.Tensor
    rowmeta: torch.Tensor
    rows_sorted: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SpgemmPlan(Container):
    """Device-resident expansion layout of one (A, B) structure.
    pa = (A nonzero, B segment) pair."""

    #: (nsegB_pad, W) int32: B's columns, each row padded to whole W-wide
    #: segments with _INT_MAX; the last segment is never written
    b2_cols: Array
    #: (nsegB_pad, W) B values, zero pads; (0, W) in pattern mode
    b2_vals: Array
    #: (npa_pad,) int32 B2 segment of each pa, in A-row order; entries past
    #: npa point at the last (all-pad) segment
    pa_b2row: Array
    #: (npa_pad,) A value of each pa; (0,) in pattern mode
    pa_aval: Array
    #: (nrow_pad, 2) int32 [first pa, pa count] per row in rows_sorted order
    rowmeta: Array
    #: (nrow_pad,) int32 row ids in stable class order, zero-padded by
    #: max_chunk rows so that no chunk's slice comes back short
    rows_sorted: Array
    classes: Tuple[int, ...]
    class_counts: Tuple[int, ...]
    seg_w: int
    npa: int
    nrow: int
    #: the budget the paddings were sized with; the plan's numeric phase
    #: schedules with it
    slot_budget: int
    a_dtype: str
    b_dtype: str
    #: all values 1.0 (the reference's forced-pattern semantics): no value
    #: tables, and a merged run's value is its length
    pattern: bool = False
    #: class-aligned partial products, one (R_pad, L) block per chunk: the
    #: numeric phase then gathers nothing.  Empty when not built.
    aligned_cols: tuple = ()
    aligned_vals: tuple = ()  #: value blocks (empty in pattern mode)
    aligned_accum: str | None = None  #: dtype of the value blocks


def _plan_tables(
    A: CSR, B: CSR, rows_sorted: torch.Tensor, *, W: int, npa_pad: int, nsegB_pad: int,
    nrow_pad: int, pattern: bool,
) -> _Tables:
    """B2 table, pa list, rowmeta and padded rows_sorted of one product; A, B
    and ``rows_sorted`` ((A.nrow,) int32, stable class order) on one device.
    No host synchronisation."""
    dev = rows_sorted.device
    a_iptr = A.indptr.long()
    a_ind = A.indices[: A.nnz].long()
    b_iptr = B.indptr.long()
    nrowB = B.shape[0]
    lenB = b_iptr[1:] - b_iptr[:-1]
    nsegB_row = (lenB + (W - 1)) // W
    bseg_off = torch.cat([nsegB_row.new_zeros(1), torch.cumsum(nsegB_row, 0)])

    # B2: nonzero k of B row j goes to slot bseg_off[j] * W + (k - b_indptr[j])
    brow = torch.repeat_interleave(torch.arange(nrowB, device=dev), lenB, output_size=B.nnz)
    dest = bseg_off[brow] * W + (torch.arange(B.nnz, device=dev) - b_iptr[brow])
    b2_cols = torch.full((nsegB_pad * W,), _INT_MAX, dtype=torch.int32, device=dev)
    b2_cols.index_copy_(0, dest, B.indices[: B.nnz].to(torch.int32))
    b2_cols = b2_cols.view(nsegB_pad, W)
    if pattern:
        b2_vals = B.data.new_zeros((0, W))
    else:
        b2_vals = B.data.new_zeros(nsegB_pad * W).index_copy_(0, dest, B.data[: B.nnz])
        b2_vals = b2_vals.view(nsegB_pad, W)

    # pa list: A nonzero q owns pas [seg_off[q], seg_off[q + 1]), one per
    # segment of B row a_ind[q]; pa t belongs to the last q with seg_off[q] <= t.
    # Pas past npa point at a spare zero entry q = nnz (A may have no nonzero
    # at all: a piece of the big path can hold only empty rows).
    jj = torch.cat([a_ind.clamp(0, nrowB - 1), a_ind.new_zeros(1)])
    nseg_a = nsegB_row[jj[:-1]]
    seg_off = torch.cat([nseg_a.new_zeros(1), torch.cumsum(nseg_a, 0)])
    t = torch.arange(npa_pad, device=dev)
    src = (torch.searchsorted(seg_off, t, right=True) - 1).clamp_(0, A.nnz)
    live = t < seg_off[-1]
    pa_b2row = torch.where(live, bseg_off[jj[src]] + (t - seg_off[src]), nsegB_pad - 1)
    pa_b2row = pa_b2row.to(torch.int32)
    if pattern:
        pa_aval = A.data.new_zeros(0)
    else:
        a_dat = torch.cat([A.data[: A.nnz], A.data.new_zeros(1)])
        pa_aval = torch.where(live, a_dat[src], 0)

    # (first pa, pa count) per row, permuted into class order
    bounds = seg_off[a_iptr]
    meta = torch.stack([bounds[:-1], bounds[1:] - bounds[:-1]], dim=1).to(torch.int32)
    nrow = A.shape[0]
    rs = torch.zeros(nrow_pad, dtype=torch.int32, device=dev)
    rs[:nrow] = rows_sorted
    rowmeta = torch.zeros((nrow_pad, 2), dtype=torch.int32, device=dev)
    rowmeta[:nrow] = meta[rows_sorted.long()]
    return _Tables(b2_cols, b2_vals, pa_b2row, pa_aval, rowmeta, rs)


def _rows_sorted(sizing: Sizing, device) -> torch.Tensor:
    """The sizing's stable class order on ``device``: the host counting sort
    when the sizing ran on the host, a stable device sort otherwise."""
    if sizing.rows_sorted is not None:
        return torch.from_numpy(np.ascontiguousarray(sizing.rows_sorted, np.int32)).to(device)
    return torch.sort(sizing.cls, stable=True).indices.to(device, torch.int32)


def spgemm_plan(
    A: CSR,
    B: CSR,
    *,
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    device=None,
    pattern: bool | None = None,
    expand: bool = True,
    accum_dtype=torch.float32,
    sizing: Sizing | None = None,
) -> SpgemmPlan:
    """Build the expansion layout on ``device`` (default: where A's tensors
    lie, the card for numpy-held operands).  Host work is the O(nnz + nrow)
    sizing; all O(expansion) work is on the device.
    ``pattern=None`` detects all-ones values (value tables omitted).

    ``expand=True`` also gathers every chunk's partial products into the
    class-aligned cache (``aligned_cols``/``aligned_vals``, values in
    ``accum_dtype``): the numeric phase then runs no gathers, for ~4 B per
    padded slot of device memory (8 in value mode)."""
    W = seg_w
    classes = _norm_classes(classes, W)
    if pattern is None:
        pattern = _is_pattern(A) and _is_pattern(B)
    dev = _device(A, device)
    check_class_limit(classes, dev)
    if sizing is None:
        sizing = _sizing(A, B, W, classes)
    tables = _plan_tables(
        A.to(dev), B.to(dev), _rows_sorted(sizing, dev),
        W=W, npa_pad=_round_up(sizing.npa, 1024), nsegB_pad=_nseg_pad(sizing.nsegB),
        nrow_pad=A.nrow + _max_chunk(classes, slot_budget), pattern=pattern,
    )
    aligned_cols, aligned_vals, aligned_accum = (), (), None
    if expand:
        sched, _ = _chunk_schedule(classes, sizing.counts, slot_budget)
        slabs = chunk_fetch_all(tables, sched, W=W, accum_dtype=accum_dtype, pattern=pattern)
        aligned_cols = tuple(col for col, _ in slabs)
        aligned_vals = () if pattern else tuple(val for _, val in slabs)
        aligned_accum = _dtype_name(accum_dtype)
    plan = SpgemmPlan(
        *tables,
        classes=classes,
        class_counts=tuple(sizing.counts),
        seg_w=W,
        npa=sizing.npa,
        nrow=A.nrow,
        slot_budget=slot_budget,
        a_dtype=_dtype_name(A.data.dtype),
        b_dtype=_dtype_name(B.data.dtype),
        pattern=pattern,
        aligned_cols=aligned_cols,
        aligned_vals=aligned_vals,
        aligned_accum=aligned_accum,
    )
    # the structure-only sizing rides along (not a field: lost by .to() and
    # serialization) so spgemm_plan_revalue skips the host pass
    object.__setattr__(plan, "_sizing_cache", (A.nnz, B.nnz, sizing))
    return plan


def spgemm_plan_revalue(
    plan: SpgemmPlan,
    A: CSR,
    B: CSR,
    *,
    device=None,
    pattern: bool | None = None,
    accum_dtype=None,
) -> SpgemmPlan:
    """A new plan for NEW VALUES on the SAME sparsity structure (the
    cuSPARSE spgemm-reuse contract; the reference's preprocess-once premise,
    SURVEY.md §0).  The structure-only host sizing is reused from ``plan``;
    the value tables and the aligned value blocks are rebuilt.  The caller
    guarantees A/B have exactly the structure ``plan`` was built from (only
    nrow/nnz are checked).  A plan that lost its sizing cache (moved with
    ``.to()`` or serialized) is sized again.  The new plan lies where
    ``plan`` does unless ``device`` names another place."""
    cache = getattr(plan, "_sizing_cache", None)
    sizing = None
    if cache is not None:
        a_nnz, b_nnz, sizing = cache
        if a_nnz != A.nnz or b_nnz != B.nnz or A.nrow != plan.nrow:
            raise ValueError(
                "operand structure differs from the plan's: "
                f"nnz {A.nnz}/{B.nnz} vs plan {a_nnz}/{b_nnz}, "
                f"nrow {A.nrow} vs {plan.nrow}"
            )
    if accum_dtype is None:
        accum_dtype = plan.aligned_accum or "float32"
    if device is None and isinstance(plan.rows_sorted, torch.Tensor):
        device = plan.rows_sorted.device
    return spgemm_plan(
        A,
        B,
        classes=plan.classes,
        seg_w=plan.seg_w,
        slot_budget=plan.slot_budget,
        device=device,
        pattern=pattern,
        expand=bool(plan.aligned_cols),
        accum_dtype=accum_dtype,
        sizing=sizing,
    )


# ---------------------------------------------------------------------------
# numeric per class chunk
# ---------------------------------------------------------------------------


def _chunks(t, sched, *, W: int, accum_dtype, pattern: bool):
    """Every (R_pad, L) slab chunk ``(L, R_pad, start, count)`` of ``sched``:
    (rows, cols_u, vals_u, nuniq) each, fetched and merged in one pass (K4 b
    on the card, one launch per block-size group)."""
    merged = chunk_merge_all(t, sched, W=W, accum_dtype=accum_dtype, pattern=pattern)
    return [(t.rows_sorted[start : start + R_pad],) + m for (_, R_pad, start, _), m in zip(sched, merged)]


def _numeric_aligned(plan: SpgemmPlan, sched, accum_dtype):
    """Every chunk of an aligned-cache plan: sort and merge (K4 c on the
    card, one launch per block-size group), no gathers."""
    merged = slab_merge_all(plan.aligned_cols, plan.aligned_vals, accum_dtype=accum_dtype,
                            pattern=plan.pattern)
    return [(plan.rows_sorted[start : start + R_pad],) + m for (_, R_pad, start, _), m in zip(sched, merged)]


def spgemm_slab_device(
    A: CSR,
    B: CSR,
    plan: SpgemmPlan | None = None,
    *,
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=torch.float32,
    device=None,
    pattern: bool | None = None,
    sizing: Sizing | None = None,
):
    """Device-resident SpGEMM: returns (chunk outputs, tail row ids, plan).
    The chunk outputs are tensors (rows, cols_u, vals_u, nuniq) per chunk — a
    slab-compressed C; the tail rows (numpy) are left to the caller.  Use
    :func:`spgemm_slab` for a host CSR.

    With a plan, its numeric phase runs: the aligned cache when it holds
    ``accum_dtype`` values, else the gathers from its tables (a plan read
    from a file moves to ``device`` first).  Without one, the tables are
    built (no aligned cache) and every chunk gathers and merges; the third
    value is then None.  ``sizing``: a precomputed ``_sizing`` result."""
    if plan is not None:
        if not isinstance(plan.rows_sorted, torch.Tensor):
            plan = plan.to(_device(A, device))
        sched, tail_start = _chunk_schedule(plan.classes, plan.class_counts, plan.slot_budget)
        if plan.aligned_cols and plan.aligned_accum == _dtype_name(accum_dtype):
            outs = _numeric_aligned(plan, sched, accum_dtype)
        else:
            outs = _chunks(plan, sched, W=plan.seg_w, accum_dtype=accum_dtype, pattern=plan.pattern)
        ntail = int(plan.class_counts[len(plan.classes)])
        tail_rows = (
            plan.rows_sorted[tail_start : tail_start + ntail].cpu().numpy()
            if ntail else np.zeros(0, np.int32)
        )
        return outs, tail_rows, plan

    plan = spgemm_plan(
        A, B, classes=classes, seg_w=seg_w, slot_budget=slot_budget, device=device,
        pattern=pattern, expand=False, accum_dtype=accum_dtype, sizing=sizing,
    )
    outs, tail_rows, _ = spgemm_slab_device(A, B, plan, accum_dtype=accum_dtype)
    return outs, tail_rows, None


def spgemm_chain_device(plan: SpgemmPlan, n_products: int = 8, *, accum_dtype=torch.float32):
    """``n_products`` numeric phases of an aligned-cache plan launched back
    to back with no synchronisation between them — the repeated-product
    steady state (same structure every step, the cuSPARSE spgemm-reuse
    contract).  The caller synchronises once; the chain's time over
    ``n_products`` is the per-product steady-state cost.  Returns the last
    product's chunk outputs (every product is the same)."""
    if not plan.aligned_cols:
        raise ValueError("spgemm_chain_device needs an aligned-cache plan (spgemm_plan(expand=True))")
    if plan.aligned_accum != _dtype_name(accum_dtype):
        raise ValueError(f"plan's aligned cache holds {plan.aligned_accum}, not {_dtype_name(accum_dtype)}")
    sched, _ = _chunk_schedule(plan.classes, plan.class_counts, plan.slot_budget)
    outs = None
    for _ in range(max(int(n_products), 1)):
        outs = _numeric_aligned(plan, sched, accum_dtype)
    return outs


def spgemm_slab_csr(
    A: CSR,
    B: CSR,
    *,
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=torch.float32,
    device=None,
    nnz_pad: int | None = None,
    pattern: bool | None = None,
    sizing: Sizing | None = None,
) -> CSR:
    """C = A @ B as a DEVICE-RESIDENT CSR (data/indices padded to
    ``nnz_pad``, int32 indptr) — chainable into further device ops without
    host transfers.  Requires no heavy-tail rows (raise the class ceiling or
    use :func:`spgemm_slab`).  ``nnz_pad`` defaults to the padded-expansion
    bound, which every output nonzero fits under."""
    W = seg_w
    classes_n = _norm_classes(classes, W)
    if sizing is None:
        sizing = _sizing(A, B, W, classes_n)
    ntail = sizing.counts[len(classes_n)]
    if ntail:
        raise ValueError(
            f"{ntail} rows exceed the largest expansion class; "
            "use spgemm_slab() (host fallback) or raise the class ceiling"
        )
    dev = _device(A, device)
    outs, _, _ = spgemm_slab_device(
        A, B, classes=classes, seg_w=seg_w, slot_budget=slot_budget, accum_dtype=accum_dtype,
        device=dev, pattern=pattern, sizing=sizing,
    )
    if nnz_pad is None:
        nnz_pad = _round_up(sizing.npa * W, 1024)
    return _csr_of(outs, (A.nrow, B.ncol), nnz_pad, accum_dtype, dev)


def _csr_of(outs, shape, nnz_pad: int, accum_dtype, device) -> CSR:
    data, indices, indptr, knnz = compact_to_csr(
        outs, nrow=shape[0], nnz_pad=nnz_pad, dtype=accum_dtype, device=device
    )
    k = int(knnz)
    if k > nnz_pad:
        raise ValueError(f"product has {k} nonzeros, more than nnz_pad={nnz_pad}")
    return CSR(data=data, indices=indices, indptr=indptr, shape=shape, nnz=k)


def _csr_to_host(C: CSR) -> CSR:
    """A device CSR's arrays cut to nnz and copied to the host (int64 indptr,
    as the JAX package's host CSRs)."""
    return CSR(
        data=as_numpy(C.data[: C.nnz]),
        indices=as_numpy(C.indices[: C.nnz]).astype(np.int32, copy=False),
        indptr=as_numpy(C.indptr).astype(np.int64),
        shape=C.shape,
        nnz=C.nnz,
    )


# ---------------------------------------------------------------------------
# automatic plan reuse
# ---------------------------------------------------------------------------

#: ``spgemm_slab`` builds a plan on the second product of the same operand
#: objects, and every later call runs its aligned numeric phase.  Weakly
#: keyed by operand identity; capped to bound device memory.
_PLAN_SEEN: dict = {}
_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 2
AUTO_PLAN_MIN_NNZ = 1 << 18


def _operand_fingerprint(A: CSR, B: CSR):
    """Cheap content fingerprint that invalidates the plan cache when an
    operand is written in place between calls (the plan bakes values and
    structure): sums over data and indices."""

    def fp(M):
        d = as_numpy(M.data[: M.nnz])
        return (
            int(M.nnz),
            float(np.add.reduce(d, dtype=np.float64)),
            int(np.add.reduce(as_numpy(M.indices[: M.nnz]), dtype=np.int64)),
        )

    return fp(A) + (fp(B) if B is not A else ())


def _operand_digest(A: CSR, B: CSR) -> str:
    """sha256 over the operands' exact bytes (data/indices trimmed to nnz,
    indptr): the checkpoint manifest's identity check across processes, where
    the sum fingerprint would accept swapped values or equal-sum
    permutations."""
    h = hashlib.sha256()
    for M in (A,) if B is A else (A, B):
        for arr in (M.data[: M.nnz], M.indices[: M.nnz], M.indptr):
            a = np.ascontiguousarray(as_numpy(arr))
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _auto_plan_lookup(key, A, B):
    ent = _PLAN_CACHE.get(key)
    if ent is not None and ent[0]() is A and ent[1]() is B:
        if ent[3] == _operand_fingerprint(A, B):
            return ent[2]
        _PLAN_CACHE.pop(key, None)  # operands written in place: invalidate
    return None


def _auto_plan_note(key, A, B, build):
    """The second sighting of the same (A, B, config) builds the plan."""
    seen = _PLAN_SEEN.get(key)
    if seen is None or seen[0]() is not A or seen[1]() is not B:
        _PLAN_SEEN[key] = (
            weakref.ref(A, lambda r, k=key: _PLAN_SEEN.pop(k, None)),
            weakref.ref(B, lambda r, k=key: _PLAN_SEEN.pop(k, None)),
        )
        return None
    plan = build()
    while len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    _PLAN_CACHE[key] = (
        weakref.ref(A, lambda r, k=key: _PLAN_CACHE.pop(k, None)),
        weakref.ref(B, lambda r, k=key: _PLAN_CACHE.pop(k, None)),
        plan,
        _operand_fingerprint(A, B),
    )
    return plan


# ---------------------------------------------------------------------------
# host-CSR entry point
# ---------------------------------------------------------------------------


def spgemm_slab(
    A: CSR,
    B: CSR,
    *,
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=torch.float32,
    device="cuda",
    as_csr: bool = True,
    pattern: bool | None = None,
    checkpoint_dir: str | None = None,
):
    """C = A @ B on ``device`` (the card unless the caller names another; no
    CUDA device raises) via per-row-class batched slab sorts (exact:
    duplicate columns merged, rows ascending, columns sorted within rows).
    Returns a host CSR (or COO).

    Products of the same host operand objects reuse a plan: the second call
    builds it (class-aligned cache, :func:`spgemm_plan`) and every later call
    runs the gather-free numeric phase (tail-free sizings, nnz >=
    AUTO_PLAN_MIN_NNZ).  Rows above the largest class take the global-sort
    ESC; products above ``_MAX_EXP_PAD`` padded slots run in row pieces
    (:func:`spgemm_slab_big`), checkpointed to ``checkpoint_dir`` if given.
    C's data is in ``accum_dtype``, an empty product's too.

    The product is structural, as the JAX package's: C holds every (i, j)
    that some A[i, k] · B[k, j] pair reaches, so partial products that
    cancel exactly, or an explicit zero in A or B, leave an entry that holds
    0, where scipy's ``A @ B`` drops it.  ``indptr`` / ``indices`` are then
    those of scipy's product of the two patterns.  A plan fixes C's
    structure whatever the values, and ``spgemm_plan_revalue`` /
    ``spgemm_dist_revalue`` rely on that."""
    dev = compute_device(device)
    check_class_limit(_norm_classes(classes, seg_w), dev)
    if pattern is None:
        pattern = _is_pattern(A) and _is_pattern(B)
    if A.nnz == 0 or B.nnz == 0:
        out = COO(
            row=np.zeros(0, np.int32),
            col=np.zeros(0, np.int32),
            data=np.zeros(0, np.dtype(_dtype_name(accum_dtype))),
            shape=(A.nrow, B.ncol),
            nnz=0,
        )
        return to_csr(out) if as_csr else out
    W = seg_w
    classes_n = _norm_classes(classes, W)
    try:
        sizing = _sizing(A, B, W, classes_n)
    except _ExpansionTooLarge as e:
        # uniform row pieces; start the piece search at the slab slots /
        # (budget / 2): the tail rows' pairs take no slots
        hint = 2
        while hint * _MAX_EXP_PAD < int(e.args[1]) * 2:
            hint *= 2
        out = spgemm_slab_big(
            A, B, classes=classes, seg_w=seg_w, slot_budget=slot_budget,
            accum_dtype=accum_dtype, device=dev, pattern=pattern, pieces_hint=hint,
            checkpoint_dir=checkpoint_dir,
        )
        return out if as_csr else to_coo(out)
    if checkpoint_dir is not None:
        warnings.warn(
            "checkpoint_dir ignored: the product fits a single call (no pieces "
            "to checkpoint); only products above the budget run in pieces",
            stacklevel=2,
        )

    ntail = sizing.counts[len(classes_n)]
    if as_csr and ntail == 0 and sizing.npa * W <= _CSR_COMPACT_MAX:
        # compact on the device; only the CSR arrays cross to the host
        plan = None
        if A.nnz >= AUTO_PLAN_MIN_NNZ and isinstance(A.data, np.ndarray):
            key = (id(A), id(B), classes_n, W, slot_budget, _dtype_name(accum_dtype), pattern,
                   str(dev))
            plan = _auto_plan_lookup(key, A, B)
            if plan is None:
                plan = _auto_plan_note(
                    key, A, B,
                    lambda: spgemm_plan(
                        A, B, classes=classes_n, seg_w=W, slot_budget=slot_budget, device=dev,
                        pattern=pattern, accum_dtype=accum_dtype, sizing=sizing,
                    ),
                )
        if plan is not None:
            sched, _ = _chunk_schedule(plan.classes, plan.class_counts, plan.slot_budget)
            Cd = _csr_of(_numeric_aligned(plan, sched, accum_dtype), (A.nrow, B.ncol),
                         _round_up(plan.npa * W, 1024), accum_dtype, dev)
        else:
            Cd = spgemm_slab_csr(
                A, B, classes=classes, seg_w=seg_w, slot_budget=slot_budget,
                accum_dtype=accum_dtype, device=dev, pattern=pattern, sizing=sizing,
            )
        return _csr_to_host(Cd)

    outs, tail_rows, _ = spgemm_slab_device(
        A, B, classes=classes, seg_w=seg_w, slot_budget=slot_budget, accum_dtype=accum_dtype,
        device=dev, pattern=pattern, sizing=sizing,
    )
    rows_l, cols_l, vals_l = _pull_chunks(outs)
    del outs
    if len(tail_rows):
        tr, tc, tv = _tail_products(A.host(), np.asarray(tail_rows, np.int64), B.host(),
                                    accum_dtype, dev)
        rows_l.append(tr)
        cols_l.append(tc)
        vals_l.append(tv)
    out = _assemble_csr(*_concat(rows_l, cols_l, vals_l, accum_dtype), (A.nrow, B.ncol))
    return out if as_csr else to_coo(out)


def _concat(rows_l, cols_l, vals_l, accum_dtype):
    npdt = np.dtype(_dtype_name(accum_dtype))
    return (
        np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64),
        np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64),
        np.concatenate(vals_l) if vals_l else np.zeros(0, npdt),
    )


# ---------------------------------------------------------------------------
# the streamed big path
# ---------------------------------------------------------------------------


def _piece_exec(A_piece: CSR, rows_sorted, sc, B_dev: CSR, *, W, npa_pad, nsegB_pad, nrow_pad,
                schedule, accum_dtype, pattern):
    """One uniform piece of a huge product: its tables, then every chunk of
    the shared schedule at the piece's own (start, count) — ``sc``, (2,
    nchunks) host ints.  Returns (rows_sorted, chunk outputs)."""
    t = _plan_tables(
        A_piece, B_dev, rows_sorted, W=W, npa_pad=npa_pad, nsegB_pad=nsegB_pad,
        nrow_pad=nrow_pad, pattern=pattern,
    )
    sched = [(L, R_pad, int(sc[0, i]), int(sc[1, i])) for i, (L, R_pad) in enumerate(schedule)]
    return t.rows_sorted, _chunks(t, sched, W=W, accum_dtype=accum_dtype, pattern=pattern)


def _piece_kw(b_iptr, W: int, npa_max: int, rows_pad: int, sched, starts, accum_dtype,
              pattern: bool) -> dict:
    """The ``_piece_exec`` keywords every piece of one uniform schedule
    shares (``sched`` / ``starts`` from ``_uniform_schedule``); ``b_iptr`` is
    the host indptr of the B the pieces multiply."""
    b_iptr64 = np.asarray(b_iptr, np.int64)
    nsegB = int(((b_iptr64[1:] - b_iptr64[:-1] + W - 1) // W).sum())
    # a piece's rows_sorted/rowmeta cover the furthest chunk of any piece
    # (start + R_pad), so no chunk's slice comes back short; max_chunk rows
    # (a plan's padding) would cost every piece a ~48 MB fill at the default
    # budget, and a heavy row can force pieces down to one row each
    furthest = starts.astype(np.int64) + np.array([R for _, R in sched], np.int64)
    return dict(
        W=W,
        npa_pad=_round_up(npa_max, 1024),
        nsegB_pad=_nseg_pad(nsegB),
        nrow_pad=max(rows_pad, int(furthest.max(initial=0))),
        schedule=tuple(sched),
        accum_dtype=accum_dtype,
        pattern=pattern,
    )


def _piece_csr(sub: CSR, cls, counts, sc, B_dev: CSR, dev, *, nclasses: int, nnz_pad: int,
               kw: dict) -> CSR:
    """One uniform piece (or shard) of a row-partitioned product as its local
    CSR (the piece's rows, B's columns): ``cls`` / ``counts`` are its rows'
    classes and class counts from ``_per_shard_sizing``, ``sc`` its (start,
    count) per chunk, ``kw`` the shared ``_piece_exec`` keywords.  Without
    tail rows the chunks compact on the device (``nnz_pad`` bounds the
    output) and the CSR stays there; with tail rows the chunks are pulled,
    the tail rows' global-sort products of ``sub`` with ``B_dev`` itself
    added, and the CSR is a host one."""
    accum_dtype = kw["accum_dtype"]
    rows_sorted = _stable_argsort_smallint(np.asarray(cls), nclasses + 2).astype(np.int32)
    _, outs = _piece_exec(sub.to(dev), torch.from_numpy(rows_sorted).to(dev), sc, B_dev, **kw)
    nt = int(counts[nclasses])
    tail = None
    if nt:
        base = int(np.asarray(counts)[:nclasses].sum())
        trows = rows_sorted[base : base + nt].astype(np.int64)
        tail = _tail_products(sub.host(), trows, B_dev, accum_dtype, dev)
    return _local_csr(outs, tail, (sub.shape[0], B_dev.shape[1]), nnz_pad, accum_dtype, dev)


def _local_csr(outs, tail, shape, nnz_pad: int, accum_dtype, dev) -> CSR:
    """A piece's (or shard's) chunk outputs and its tail rows' products
    (``(rows, cols, vals)`` host arrays, or None) as its local CSR: compacted
    on the device without tail rows, assembled on the host with them."""
    if tail is None and not outs:  # the piece holds only empty rows
        return CSR(data=torch.zeros(0, dtype=_torch_dtype(accum_dtype), device=dev),
                   indices=torch.zeros(0, dtype=torch.int32, device=dev),
                   indptr=torch.zeros(shape[0] + 1, dtype=torch.int64, device=dev),
                   shape=shape, nnz=0)
    if tail is None:
        return _csr_of(outs, shape, nnz_pad, accum_dtype, dev)
    rows_l, cols_l, vals_l = _pull_chunks(outs)
    for acc, x in zip((rows_l, cols_l, vals_l), tail):
        acc.append(x)
    return _assemble_csr(*_concat(rows_l, cols_l, vals_l, accum_dtype), shape)


#: a piece file that these errors come from is torn (a crash mid-write) and
#: is recomputed; any other error (an OSError of the disk, say) propagates and
#: leaves the file in place
_TORN_PIECE_ERRORS = (zipfile.BadZipFile, KeyError, ValueError, EOFError)


class _BigCheckpoint:
    """Piece-granular checkpoint/resume for :func:`spgemm_slab_big`.

    The reference has no checkpoint/resume at all (SURVEY.md §5).  Each
    finished piece's CSR triple is written atomically (one .npz per piece),
    and a manifest pins the product it belongs to: a re-run with the same
    ``checkpoint_dir`` skips finished pieces, and a manifest mismatch
    (other operands or config) raises rather than mixing two products.

    ``extra`` adds keys to the manifest (the distributed big path pins its
    shard count and B layout).  Where several processes share the directory,
    one writes (``writer=True``: it writes the manifest and drops stale or
    torn files) and the others only read, after it: a reader finds no
    manifest, or a different one, and raises."""

    def __init__(self, path, A, B, P, classes, W, slot_budget, accum, pattern, extra=None,
                 writer: bool = True):
        self.dir = path
        self.writer = writer
        manifest = {
            # repr strings: a NaN in the data would make the JSON round trip
            # compare NaN != NaN and refuse a valid resume
            "fingerprint": [repr(x) for x in _operand_fingerprint(A, B)],
            "sha256": _operand_digest(A, B),
            "shape_a": list(A.shape),
            "shape_b": list(B.shape),
            "pieces": int(P),
            "classes": list(classes),
            "seg_w": int(W),
            "slot_budget": int(slot_budget),
            "accum_dtype": accum,
            "pattern": bool(pattern),
            **(extra or {}),
        }
        mpath = os.path.join(path, "manifest.json")
        prev = None
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    prev = json.load(f)
            except ValueError:
                prev = None  # torn manifest: rewritten below
        if prev is not None:
            if prev != manifest:
                raise ValueError(
                    f"checkpoint dir {path!r} holds a different product/config "
                    "(manifest mismatch); point at a fresh directory"
                )
        elif not writer:
            raise ValueError(
                f"checkpoint dir {path!r} holds no manifest after its writer made it: "
                "it must be a directory that every process sees"
            )
        else:
            os.makedirs(path, exist_ok=True)
            # no (or a torn) manifest: piece files present are unattributable
            for fp in glob.glob(os.path.join(path, "piece_*.npz")):
                os.remove(fp)
            tmp = mpath + ".tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, mpath)

    def _piece_path(self, p: int) -> str:
        return os.path.join(self.dir, f"piece_{p:05d}.npz")

    def _read(self, p: int, keys):
        fp = self._piece_path(p)
        if not os.path.exists(fp):
            return None
        try:
            with np.load(fp) as z:
                return [z[k] for k in keys]
        except _TORN_PIECE_ERRORS:
            if self.writer:  # a reader leaves the file to the writer
                os.remove(fp)
            return None

    def _write(self, p: int, arrays: dict) -> None:
        fp = self._piece_path(p)
        tmp = fp + ".tmp.npz"  # np.savez appends .npz to other names
        np.savez(tmp, **arrays)
        os.replace(tmp, fp)  # atomic: a crash never leaves a torn piece file

    def load(self, p: int):
        got = self._read(p, ("data", "indices", "indptr"))
        return None if got is None else tuple(got)

    def save(self, p: int, triple) -> None:
        data, indices, indptr = triple
        self._write(p, dict(data=data, indices=indices, indptr=indptr))

    # one file per piece holding every shard's local CSR triple (the
    # distributed big path)
    def load_multi(self, p: int, nsh: int):
        got = self._read(p, [f"{k}{s}" for s in range(nsh) for k in ("data", "ind", "iptr")])
        return None if got is None else [tuple(got[3 * s : 3 * s + 3]) for s in range(nsh)]

    def save_multi(self, p: int, triples) -> None:
        arrs = {}
        for s, (data, indices, indptr) in enumerate(triples):
            arrs[f"data{s}"], arrs[f"ind{s}"], arrs[f"iptr{s}"] = data, indices, indptr
        self._write(p, arrs)


def spgemm_slab_big(
    A: CSR,
    B: CSR,
    *,
    pieces: int | None = None,
    pieces_hint: int | None = None,
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=torch.float32,
    device="cuda",
    pattern: bool | None = None,
    checkpoint_dir: str | None = None,
) -> CSR:
    """C = A @ B for products whose padded expansion exceeds the single-call
    budget: A is cut into uniform row pieces that share one chunk schedule
    (:func:`_piece_exec`); each piece's output is pulled to the host and
    freed, so the device peak stays piece-sized.  ``pieces`` defaults to the
    smallest power of two whose largest piece fits ``_MAX_EXP_PAD`` padded
    slots.  Runs on ``device``, the card by default.  Returns a host CSR.

    ``checkpoint_dir``: persist each finished piece and resume a killed run
    from them (:class:`_BigCheckpoint`).  The caller owns the directory."""
    from spmm_tpu_torch.parallel.spgemm_spmd import _uniform_schedule

    dev = compute_device(device)
    W = seg_w
    classes = _norm_classes(classes, W)
    check_class_limit(classes, dev)
    if pattern is None:
        pattern = _is_pattern(A) and _is_pattern(B)

    P, S, (cls, counts, npa_max, nnz_s, _), body_max = _choose_pieces(
        A, B, W, classes, pieces, pieces_hint or 2)
    sched, starts, cnts, _ = _uniform_schedule(
        classes=classes, counts=counts[:, : len(classes) + 1], slot_budget=slot_budget
    )
    sc_tab = np.stack([starts, cnts], axis=1)  # (P, 2, nchunks)

    Bh = B.host()
    rows_pad = S.rows_per_shard
    kw = _piece_kw(Bh.indptr, W, npa_max, rows_pad, sched, starts, accum_dtype, pattern)
    B_dev = Bh.to(dev)

    # per piece: (data, indices, local indptr) as tight host arrays
    ckpt = (
        _BigCheckpoint(checkpoint_dir, A, B, P, classes, W, slot_budget,
                       _dtype_name(accum_dtype), pattern)
        if checkpoint_dir is not None
        else None
    )
    # only tail-free pieces compact on the device, and their pairs are all body
    nnz_pad_piece = _round_up(body_max * W, 1024)
    piece_csrs = []
    for p in range(P):
        if ckpt is not None:
            got = ckpt.load(p)
            if got is not None:
                piece_csrs.append(got)
                continue
        sub = CSR(
            data=S.data[p], indices=S.indices[p], indptr=S.indptr[p].astype(np.int64),
            shape=(rows_pad, A.shape[1]), nnz=int(nnz_s[p]),
        )
        Cp = _csr_to_host(_piece_csr(sub, cls[p], counts[p], sc_tab[p], B_dev, dev,
                                     nclasses=len(classes), nnz_pad=nnz_pad_piece, kw=kw))
        piece = (Cp.data, Cp.indices, Cp.indptr)
        piece_csrs.append(piece)
        if ckpt is not None:
            ckpt.save(p, piece)

    return _stitch(piece_csrs, A.nrow, B.ncol)


def _choose_pieces(A: CSR, B: CSR, W: int, classes, pieces: int | None, P0: int, nsh: int = 1,
                   times: list | None = None):
    """The piece count of a streamed product: A's rows cut into ``nsh * P``
    uniform blocks (``nsh`` shards of ``P`` pieces each), ``P`` as given by
    ``pieces``, else from ``P0`` doubled until every block's slab slots fit
    ``_MAX_EXP_PAD`` (tail rows' pairs take none) or the blocks are one row.
    A block whose expansion overflows int32 doubles ``P`` in either case.
    Returns (P, the blocks' ShardedCSR, their ``_per_shard_sizing``, the
    largest block's body pairs); ``times`` ends holding each returned
    block's host sizing ms."""
    from spmm_tpu_torch.parallel.partition import partition_rows
    from spmm_tpu_torch.parallel.spgemm_spmd import _per_shard_sizing

    P = pieces or P0
    while True:
        S = partition_rows(A, nsh * P)
        # one row alone can exceed the budget (it becomes a tail row): stop
        # splitting at one-row blocks
        at_min = S.rows_per_shard <= 1 or nsh * P >= A.nrow
        if times is not None:
            times.clear()
        try:
            sizing = _per_shard_sizing(S, B, W, classes, times=times)
        except ValueError:  # a block still exceeds the int32 expansion
            if at_min:
                raise
            P *= 2
            continue
        body_max = int(sizing[4].max(initial=0))
        if pieces is not None or body_max * W <= _MAX_EXP_PAD or at_min:
            return P, S, sizing, body_max
        P *= 2


def _stitch(triples, nrow: int, ncol: int) -> CSR:
    """Row-block CSR triples ``(data, indices, local indptr)`` in global row
    order as one host CSR; the rows past ``nrow`` (the last block's padding)
    are cropped."""
    iptrs, off = [], 0
    for i, (_, _, ip) in enumerate(triples):
        ip = np.asarray(ip, np.int64) + off
        iptrs.append(ip if i == 0 else ip[1:])
        off = int(ip[-1])
    indptr = np.concatenate(iptrs)
    return CSR(
        data=np.concatenate([t[0] for t in triples]),
        indices=np.concatenate([t[1] for t in triples]).astype(np.int32, copy=False),
        indptr=indptr[: nrow + 1],
        shape=(nrow, ncol),
        nnz=int(indptr[nrow]),
    )


# ---------------------------------------------------------------------------
# host assembly
# ---------------------------------------------------------------------------


def _pull_chunks(outs):
    """Chunk outputs → host (rows, cols, vals) lists, each chunk's live
    entries selected on the device before the copy."""
    rows_l, cols_l, vals_l = [], [], []
    for r, cols_u, vals_u, nuniq in outs:
        live = torch.arange(cols_u.shape[1], device=cols_u.device)[None, :] < nuniq[:, None]
        rows_l.append(torch.repeat_interleave(r.long(), nuniq.long()).cpu().numpy())
        cols_l.append(cols_u[live].long().cpu().numpy())
        vals_l.append(vals_u[live].cpu().numpy())
    return rows_l, cols_l, vals_l


def _tail_products(H: CSR, trows: np.ndarray, B: CSR, accum_dtype, device):
    """Heavy-tail rows through the global-sort ESC on ``device``: products of
    ``H``'s rows ``trows`` with B (on the host or on ``device``: it is not
    copied again), in ``accum_dtype`` like the slab rows.  Returns (rows in
    H's row space, cols, vals)."""
    npdt = np.dtype(_dtype_name(accum_dtype))
    sub = _take_rows(H, trows)
    sub = dataclasses.replace(sub, data=np.asarray(sub.data, npdt))
    if isinstance(B.data, torch.Tensor):
        Bc = dataclasses.replace(B, data=B.data.to(_torch_dtype(accum_dtype)))
    else:
        Bc = dataclasses.replace(B, data=np.asarray(B.data, npdt))
    Ct = spgemm_sorted(sub, Bc, device=device, as_csr=False)
    return (
        trows[np.asarray(Ct.row[: Ct.nnz], np.int64)],
        np.asarray(Ct.col[: Ct.nnz], np.int64),
        np.asarray(Ct.data[: Ct.nnz]),
    )


def _assemble_csr(rows, cols, vals, shape) -> CSR:
    """Concatenated chunk outputs → canonical CSR without a comparison sort:
    each row lives in exactly one chunk with its columns already sorted, so
    a stable sort by row id alone (native counting sort) gives the order."""
    nrow = shape[0]
    counts = np.bincount(rows, minlength=nrow) if len(rows) else np.zeros(nrow, np.int64)
    out_indptr = np.zeros(nrow + 1, dtype=np.int64)
    np.cumsum(counts, out=out_indptr[1:])
    nnz_out = int(out_indptr[-1])
    c_ind = np.empty(nnz_out, dtype=np.int32)
    c_dat = np.empty(nnz_out, dtype=vals.dtype)
    if nnz_out:
        order = _stable_argsort_smallint(rows, nrow)
        c_ind[:] = cols[order]
        c_dat[:] = vals[order]
    return CSR(data=c_dat, indices=c_ind, indptr=out_indptr, shape=shape, nnz=nnz_out)


def _take_rows(Ah: CSR, rows: np.ndarray) -> CSR:
    """Sub-CSR holding only ``rows`` (same width, len(rows) height)."""
    indptr = np.asarray(Ah.indptr, dtype=np.int64)
    starts, lens = indptr[rows], indptr[rows + 1] - indptr[rows]
    nnz = int(lens.sum())
    new_iptr = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(lens, out=new_iptr[1:])
    pos = np.arange(nnz, dtype=np.int64)
    rof = np.repeat(np.arange(len(rows), dtype=np.int64), lens)
    src = starts[rof] + (pos - new_iptr[rof])
    return CSR(
        data=np.asarray(Ah.data)[src],
        indices=np.asarray(Ah.indices, np.int32)[src],
        indptr=new_iptr,
        shape=(len(rows), Ah.shape[1]),
        nnz=nnz,
    )
