"""Segment primitives (``spmm_tpu/ops/segments.py``, and the ordered
counterpart of ``jax.ops.segment_sum``).

- :func:`boundary_segments`: sorted boundaries → per-element segment ids,
  with one scatter-add and one cumsum (O(n), no binary search).
- :func:`segment_sum`: the rows of ``data`` summed per segment in a fixed
  order, with no atomics, so that the same inputs give the same bits on
  every run (the reference's contract, ``tests/test_aux.py``).  A
  :class:`SegmentPlan` -- the segments' offsets and, for unsorted ids, a
  stable order of the rows -- is built once per structure
  (:func:`segment_plan`) and kept by the callers beside their views.  CUDA
  tensors launch the ordered-sum kernel ``csrc/segment_sum.cu``; CPU tensors
  take its plain version, :func:`segment_sum_reference`.

``index_add_``, which this replaces in the products, adds with atomics on
CUDA, in an order that changes from run to run.  Prefix sums and their
differences would be ordered too, but lose the small segments in fp32 behind
a long prefix, so they are not used.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from spmm_tpu_torch import kernels
from spmm_tpu_torch.formats.containers import as_tensor, device_of

#: CUDA calls of the ordered-sum kernel in this process, one per call (a call
#: that spans several chunks makes two launches; chip_smoke.py resets and
#: reads the count)
launches = 0

_DTYPES = {torch.float32: kernels.F32, torch.float64: kernels.F64,
           torch.int32: kernels.I32, torch.int64: kernels.I64}


def boundary_segments(boundaries, out_size: int, *, dtype=torch.int32, device=None) -> torch.Tensor:
    """For sorted ``boundaries`` with ``boundaries[0] == 0``, returns
    ``seg[e] = searchsorted(boundaries, e, side="right") - 1`` for
    ``e in [0, out_size)``, except that positions at/after ``boundaries[-1]``
    saturate at ``len(boundaries) - 2`` (the last segment).

    ``boundary_segments(indptr, nnz_pad)`` is CSR indptr → per-nonzero row ids.
    The result lies on ``device`` (default: that of ``boundaries``, the CPU
    for a numpy array).
    """
    if device is None:
        device = device_of(boundaries)
    b = as_tensor(boundaries, device).to(torch.int64)[1:-1]
    b = b[b < out_size]  # out-of-range boundaries are dropped, as a scatter with mode="drop"
    z = torch.zeros((out_size,), dtype=torch.int64, device=device)
    z.index_add_(0, b, torch.ones_like(b))
    return torch.cumsum(z, 0).to(dtype)


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """What an ordered segment sum needs of its ids, built once per
    structure: segment s takes positions ``offsets[s] .. offsets[s+1]`` of
    the rows in segment order, and position i is row ``order[i]`` of the
    data (row i itself when ``order`` is None: ids already sorted)."""

    offsets: torch.Tensor  # (num_segments + 1,) int64
    order: torch.Tensor | None  # (N,) int64

    @property
    def num_segments(self) -> int:
        return self.offsets.shape[0] - 1


def segment_plan(segment_ids, num_segments: int, *, indices_are_sorted: bool = False,
                 device=None) -> SegmentPlan:
    """The plan of ``segment_ids`` (N,) over ``num_segments`` segments.  Ids
    outside ``[0, num_segments)`` take no part, as in ``jax.ops.segment_sum``.
    Unsorted ids are put in a stable order (rows of one segment keep their
    order)."""
    ids = as_tensor(segment_ids, device or device_of(segment_ids)).long()
    order = None
    if not indices_are_sorted:
        ids, order = torch.sort(ids, stable=True)
    marks = torch.arange(num_segments + 1, device=ids.device)
    return SegmentPlan(torch.searchsorted(ids, marks), order)


def offsets_plan(offsets, device) -> SegmentPlan:
    """The plan of segments given by their sorted offsets (a CSR's indptr)."""
    return SegmentPlan(as_tensor(offsets, device).long(), None)


def segment_sum_reference(data: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Plain PyTorch :func:`segment_sum`: the rows in segment order, then
    ``torch.segment_reduce`` over the offsets (each segment summed in its
    order; autograd differentiates it as it stands).  Integer rows, which
    ``segment_reduce`` does not take, are added by ``index_add_``: integer
    sums are exact in any order."""
    rows = data if plan.order is None else data.index_select(0, plan.order)
    off = plan.offsets
    if off.numel() and int(off[0]):  # rows before the first segment take no part
        rows, off = rows[int(off[0]):], off - off[0]
    if rows.dtype.is_floating_point:
        return torch.segment_reduce(rows, "sum", offsets=off, axis=0)
    seg = torch.repeat_interleave(torch.arange(plan.num_segments, device=rows.device), off[1:] - off[:-1])
    out = torch.zeros((plan.num_segments, *rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, seg, rows[: seg.numel()])


#: threads per CTA (the kernel's kThreads), the most columns one CTA takes
#: (a column tile), and the bytes of one chunk of rows staged in shared
#: memory: twice as many where a row fills a warp (three such CTAs fit an SM,
#: each mostly a chain of latencies, so the chunk sets the bytes in flight)
THREADS = 256
TILE_COLS = 128
CHUNK_BYTES = 32 * 1024
CHUNK_BYTES_WIDE = 64 * 1024


@functools.lru_cache(maxsize=None)
def chunk_layout(k: int, itemsize: int) -> tuple[int, int, int]:
    """``(kt, ct, ipt)`` of the ordered-sum kernel for k columns of
    ``itemsize``-byte values: ``kt`` columns per column tile, ``ct`` lanes
    per row (a power of two, at most a warp), ``ipt`` consecutive rows per
    lane group.  A chunk of ``P = (THREADS // ct) * ipt`` positions, about
    ``CHUNK_BYTES`` of rows (``CHUNK_BYTES_WIDE`` where a row takes a warp),
    is one CTA's work.  The summation order follows from these alone (k and
    the dtype), never from the data or its alignment."""
    kt = max(1, min(k, TILE_COLS))
    ct = min(1 << (kt - 1).bit_length(), 32)
    groups = THREADS // ct
    chunk = CHUNK_BYTES_WIDE if ct == 32 else CHUNK_BYTES
    ipt = max(4, 1 << max(0, (chunk // (groups * kt * itemsize)).bit_length() - 1))
    return kt, ct, ipt


def _launch(data: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """The ordered-sum kernel: (num_segments, k) from (N, k).  One launch
    when N fits one chunk (:func:`chunk_layout`), else two: the chunks, then
    the fix-up that adds the partials of the segments that cross chunks."""
    global launches
    if data.dtype not in _DTYPES:
        raise TypeError(f"segment_sum: dtype {data.dtype} not supported (float32, float64, int32, int64)")
    data = data.contiguous()
    n, k = data.shape
    nseg = plan.num_segments
    out = torch.empty((nseg, k), dtype=data.dtype, device=data.device)
    if nseg == 0 or k == 0:
        return out
    es = data.element_size()
    kt, ct, ipt = chunk_layout(k, es)
    chunk = (THREADS // ct) * ipt
    nchunks = max(1, -(-n // chunk))
    wide = 16 // es
    run = plan.order is None and k <= kt  # the chunk's rows are one contiguous run
    vec = wide if data.data_ptr() % 16 == 0 and (run or k % wide == 0) else 1
    scratch = None
    if nchunks > 1:  # per chunk: a segment id, then two partial rows
        scratch = torch.empty((nchunks * (8 + 2 * k * es),), dtype=torch.uint8, device=data.device)
    order = plan.order
    launches += 1
    err = kernels.lib().segment_sum_launch(
        data.data_ptr(), plan.offsets.data_ptr(), 0 if order is None else order.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), _DTYPES[data.dtype], n, nseg, k,
        vec, kt, ct.bit_length() - 1, ipt, kernels.stream_ptr(data.device))
    kernels.check(err, "segment_sum")
    return out


class _SegmentSum(torch.autograd.Function):
    """The kernel with its backward: each row's gradient is its segment's
    (a gather, written once per row: no atomics)."""

    @staticmethod
    def forward(ctx, data, plan):
        ctx.plan, ctx.n = plan, data.shape[0]
        return _launch(data, plan)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        plan = ctx.plan
        off = plan.offsets
        lens = off[1:] - off[:-1]
        lo = int(off[0])
        seg = torch.repeat_interleave(torch.arange(plan.num_segments, device=g.device), lens)
        gd = g.new_zeros((ctx.n, g.shape[1]))
        pos = torch.arange(lo, lo + seg.numel(), device=g.device)
        rows = pos if plan.order is None else plan.order[pos]
        gd.index_copy_(0, rows, g.index_select(0, seg))
        return gd, None


def segment_sum(data: torch.Tensor, segment_ids=None, num_segments: int | None = None, *,
                indices_are_sorted: bool = False, plan: SegmentPlan | None = None) -> torch.Tensor:
    """``out[s] = Σ data[i]`` over the rows i whose id is s, each segment
    summed in a fixed order: the counterpart of ``jax.ops.segment_sum``,
    bit-reproducible.  ``data`` is (N,) or (N, k); the result (num_segments,)
    or (num_segments, k) in data's dtype.  Pass ``plan`` (:func:`segment_plan`,
    :func:`offsets_plan`) to reuse one structure's order and offsets instead
    of ids.  CUDA tensors launch the ordered-sum kernel (recorded for
    autograd when data requires grad), CPU tensors take the plain version."""
    if plan is None:
        plan = segment_plan(segment_ids, num_segments, indices_are_sorted=indices_are_sorted,
                            device=data.device)
    flat = data.dim() == 1
    d2 = data[:, None] if flat else data
    if data.device.type == "cpu":
        out = segment_sum_reference(d2, plan)
    elif data.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {data.device}")
    elif torch.is_grad_enabled() and data.requires_grad:
        out = _SegmentSum.apply(d2, plan)
    else:
        out = _launch(d2, plan)
    return out[:, 0] if flat else out
