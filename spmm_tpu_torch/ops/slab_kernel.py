"""K4 and K5: the slab SpGEMM's numeric phase on hand-written kernels
(``csrc/slab_spgemm.cu``), and their plain PyTorch versions.

Per class chunk of (R_pad, L) partial-product slots (``ops/slab_spgemm.py``):

- :func:`chunk_fetch` (K4 a): the chunk's slab, (R_pad, L) columns with
  ``_INT_MAX`` pads and the partial products in ``accum_dtype`` (the
  class-aligned cache of ``spgemm_plan(expand=True)``); plain version
  :func:`_chunk_fetch`, to which the kernel is bit-identical.
- :func:`chunk_merge` (K4 b): the slab made in shared memory and merged at
  once, never written out: ``(cols_u, vals_u, nuniq)``; plain version
  :func:`_merge_block` of :func:`_chunk_fetch`.
- :func:`slab_merge` (K4 c): the same merge of a cached slab; plain version
  :func:`_merge_block`.
- :func:`compact_to_csr` (K5): the chunks' merged rows as device CSR arrays;
  plain version :func:`_compact_to_csr`.

The merge's contract: each row's unique columns ascend in its first
``nuniq`` slots with the run sums beside them (in pattern mode the run
length, an exact count).  The kernels sum each run directly in slot order
and write ``_INT_MAX`` / 0 past ``nuniq``; the plain version takes
differences of inclusive prefix sums (about 1 ulp per run in value mode)
and leaves other values there.  Every consumer masks by ``nuniq``.

CUDA tensors launch the kernels, CPU tensors take the plain versions; any
other device raises, and nothing falls back from a kernel to a plain
version.  The JAX package runs these stages as XLA device ops
(``spmm_tpu/ops/slab_spgemm.py: _chunk_fetch`` :1012, ``_merge_block``
:1073, ``_compact_to_csr`` :1280): no TPU kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmm_tpu_torch import kernels

_INT_MAX = int(np.iinfo(np.int32).max)

#: K4 launches in this process by entry (a, b, c), one per call; K5
#: launches, one per chunk (chip_smoke.py resets and reads them)
slab_launches = {"fetch": 0, "fetch_merge": 0, "merge": 0}
compact_launches = 0

#: the widest class (slots per row) the merge takes: a row sorts in one CTA's
#: shared memory, 14 B per slot in fp64 (a 4-byte column, a 2-byte slot index,
#: the value), 229,376 B at 16,384 slots of the 232,448 a CTA may use
MAX_L = 16384

#: slots of one merge tile (a CTA): rows of up to this many padded slots
#: share a CTA, wider rows take one each
TILE_SLOTS = {torch.float32: 4096, torch.float64: 2048}

#: consecutive padded slots a merge thread sorts in its registers (the
#: kernel's kPer)
SLOTS_PER_THREAD = 16

_VALUE_CODES = {torch.float32: kernels.F32, torch.float64: kernels.F64, torch.bfloat16: kernels.BF16,
                torch.float16: kernels.F16, torch.int32: kernels.I32, torch.int64: kernels.I64}
_ACC_CODES = {torch.float32: kernels.F32, torch.float64: kernels.F64}


def _torch_dtype(dt) -> torch.dtype:
    return dt if isinstance(dt, torch.dtype) else getattr(torch, np.dtype(dt).name)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _chunk_meta(rowmeta, start: int, count: int, R_pad: int, nblk: int):
    """(base, bm) of one chunk's row range: each row's first pa, and the
    (R_pad, nblk) mask of its live pa blocks (rows past ``count`` have none)."""
    mm = rowmeta[start : start + R_pad]
    if mm.shape[0] != R_pad:
        raise ValueError(f"chunk rows [{start}, {start + R_pad}) run past the plan's padding")
    dev = rowmeta.device
    in_chunk = torch.arange(R_pad, device=dev) < count
    base = torch.where(in_chunk, mm[:, 0], 0)
    nb = torch.where(in_chunk, mm[:, 1], 0)
    bm = torch.arange(nblk, device=dev)[None, :] < nb[:, None]
    return base, bm


def _chunk_fetch(t, base, bm, *, L: int, R_pad: int, W: int, accum_dtype, pattern: bool):
    """The gather half of a chunk: each row's pa entries, then their B2
    segments.  Returns (col, val): (R_pad, L) columns with _INT_MAX pads and,
    in value mode, the partial products in ``accum_dtype`` (zero at pads);
    val is None in pattern mode."""
    nblk = L // W
    dev = base.device
    npa_pad = t.pa_b2row.shape[0]
    last_seg = t.b2_cols.shape[0] - 1
    pa = (base.long()[:, None] + torch.arange(nblk, device=dev)).clamp_(0, npa_pad - 1)
    # blocks of other rows and of padding read the never-written last
    # segment, which is all _INT_MAX: the gather masks them
    b2r = torch.where(bm, t.pa_b2row[pa].long().clamp_(0, last_seg), last_seg)
    col = t.b2_cols[b2r].reshape(R_pad, L)
    if pattern:
        return col, None
    acc = _torch_dtype(accum_dtype)
    val = t.b2_vals[b2r].to(acc) * t.pa_aval[pa].to(acc)[:, :, None]
    val = torch.where(col != _INT_MAX, val.reshape(R_pad, L), 0)
    return col, val


def _merge_block(col, val, *, accum_dtype, pattern: bool):
    """The sort/merge half of a chunk: (R_pad, L) columns with _INT_MAX pads
    (and values in value mode) → (cols_u, vals_u, nuniq): each row's unique
    columns ascending in its first nuniq slots, with their summed values.

    Duplicates merge without atomics: the last element of each run keeps the
    inclusive prefix sum of the sorted values; a stable sort moves those to
    the front, and a run's sum is the difference of consecutive ones.  In
    pattern mode the prefix sum of ones is the position, so a run's value is
    a difference of positions: exact integer counts."""
    R_pad, L = col.shape
    acc = _torch_dtype(accum_dtype)
    if pattern:
        col_s = torch.sort(col, dim=1, stable=True).values
    else:
        col_s, order = torch.sort(col, dim=1, stable=True)
        val_s = val.gather(1, order)
    last = torch.ones_like(col_s, dtype=torch.bool)
    last[:, :-1] = col_s[:, 1:] != col_s[:, :-1]
    live = last & (col_s != _INT_MAX)
    p = torch.arange(L, dtype=torch.int32, device=col.device).expand(R_pad, L)
    out_key = torch.where(live, p, _INT_MAX)
    outk_s, order_u = torch.sort(out_key, dim=1, stable=True)
    cols_u = col_s.gather(1, order_u)
    nuniq = live.sum(dim=1, dtype=torch.int32)
    if pattern:
        csum_u = outk_s.to(acc) + 1  # the inclusive count of ones up to the run's end
    else:
        csum_u = torch.cumsum(val_s, dim=1).gather(1, order_u)
    vals_u = torch.diff(csum_u, dim=1, prepend=csum_u.new_zeros((R_pad, 1)))
    return cols_u, vals_u, nuniq


def _row_offsets(outs, nrow: int, device):
    """The CSR indptr (nrow + 1,) int64 of chunk outputs: a chunk's padded
    rows repeat ids of other rows with nuniq 0, so row counts merge by max."""
    counts = torch.zeros(nrow, dtype=torch.int32, device=device)
    for r, _, _, nu in outs:
        counts.scatter_reduce_(0, r.long(), nu, reduce="amax")
    indptr = torch.zeros(nrow + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return indptr


def _compact_to_csr(outs, *, nrow: int, nnz_pad: int, dtype, device):
    """Slab-compressed chunk outputs → device CSR arrays (data, indices,
    indptr, nnz as a 0-d tensor).  Entries past a row's nuniq (or past
    ``nnz_pad``) are written to one spare slot that is cut off.  Every kept
    slot is written once: the result is deterministic."""
    indptr = _row_offsets(outs, nrow, device)
    data = torch.zeros(nnz_pad + 1, dtype=_torch_dtype(dtype), device=device)
    indices = torch.zeros(nnz_pad + 1, dtype=torch.int32, device=device)
    for r, cols_u, vals_u, nu in outs:
        pp = torch.arange(cols_u.shape[1], device=device)
        dest = indptr[r.long()][:, None] + pp
        dest = torch.where((pp < nu[:, None]) & (dest < nnz_pad), dest, nnz_pad).view(-1)
        data.index_put_((dest,), vals_u.reshape(-1).to(data.dtype))
        indices.index_put_((dest,), cols_u.reshape(-1))
    return data[:nnz_pad], indices[:nnz_pad], indptr.to(torch.int32), indptr[-1]


# ---------------------------------------------------------------------------
# the kernels' layout and launches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """How the merge kernel cuts a chunk of (R_pad, L) slots: each row padded
    to ``lp`` slots (a power of two), ``rows`` consecutive rows per CTA
    (``tiles`` CTAs of ``threads`` threads, CTA t taking rows [t * rows,
    (t + 1) * rows) of the chunk, rows past R_pad empty), ``smem`` bytes of
    dynamic shared memory."""

    lp: int
    rows: int
    tiles: int
    threads: int
    smem: int

    @property
    def slots(self) -> int:
        return self.rows * self.lp


def tile_layout(L: int, R_pad: int, accum_dtype, pattern: bool) -> TileLayout:
    """The merge kernel's layout of a chunk (see :class:`TileLayout`): a tile
    of ``TILE_SLOTS`` padded slots, or one row where a row is wider; a
    thread per ``SLOTS_PER_THREAD`` consecutive slots (128 to 1,024 a CTA).
    Raises ValueError for a class wider than ``MAX_L``."""
    acc = _torch_dtype(accum_dtype)
    if acc not in TILE_SLOTS:
        raise TypeError(f"slab merge kernel: accum_dtype {acc} not supported (float32, float64)")
    if not 1 <= L <= MAX_L:
        raise ValueError(f"slab merge kernel: a class of {L} slots per row is above its limit of "
                         f"{MAX_L} (MAX_L); use classes up to {MAX_L}")
    lp = 1 << (L - 1).bit_length()
    tp = max(TILE_SLOTS[acc], lp)
    rows = tp // lp
    threads = tp // SLOTS_PER_THREAD
    value_bytes = 0 if pattern else acc.itemsize
    smem = tp * (value_bytes + 4 + 2) + 4 * (rows + 1) + 4 * 32
    return TileLayout(lp=lp, rows=rows, tiles=-(-R_pad // rows), threads=threads, smem=smem)


def check_class_limit(classes, device) -> None:
    """On CUDA operands a class above ``MAX_L`` raises before any work: the
    kernels take no wider row, and nothing falls back to the plain version."""
    if torch.device(device).type == "cuda" and classes and max(classes) > MAX_L:
        raise ValueError(f"class of {max(classes)} slots per row is above the slab kernels' limit of "
                         f"{MAX_L} (ops.slab_kernel.MAX_L) on CUDA operands; use classes up to {MAX_L}")


def _on_card(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the kernel's route), False for a CPU one (the
    plain version's); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"{what}: unsupported device {x.device}")


def _need(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _ptr(x: torch.Tensor | None):
    return None if x is None or x.numel() == 0 else x.data_ptr()


def _table_args(t, start: int, count: int, R_pad: int, L: int, W: int, pattern: bool, what: str):
    """The C entries' table arguments, after the checks the kernels rely on."""
    dev = t.rowmeta.device
    tabs = [t.b2_cols, t.pa_b2row, t.rowmeta] + ([] if pattern else [t.b2_vals, t.pa_aval])
    _need(all(isinstance(x, torch.Tensor) and x.device == dev and x.is_contiguous() for x in tabs), what,
          f"the tables must be contiguous tensors on {dev}")
    _need(t.b2_cols.dtype == torch.int32 and t.b2_cols.dim() == 2 and t.b2_cols.shape[1] == W, what,
          f"b2_cols must be (nsegB_pad, {W}) int32")
    _need(t.pa_b2row.dtype == torch.int32 and t.rowmeta.dtype == torch.int32
          and t.rowmeta.dim() == 2 and t.rowmeta.shape[1] == 2, what,
          "pa_b2row and rowmeta (nrow_pad, 2) must be int32")
    _need(W >= 1 and L % W == 0 and t.b2_cols.shape[0] >= 1 and t.pa_b2row.shape[0] >= 1, what,
          f"L={L} must be a multiple of W={W}, over non-empty tables")
    if start < 0 or start + R_pad > t.rowmeta.shape[0]:
        raise ValueError(f"chunk rows [{start}, {start + R_pad}) run past the plan's padding")
    a_code = b_code = 0
    if not pattern:
        for x, name in ((t.b2_vals, "b2_vals"), (t.pa_aval, "pa_aval")):
            if x.dtype not in _VALUE_CODES:
                raise TypeError(f"{what}: {name} dtype {x.dtype} not supported "
                                f"({', '.join(str(d) for d in _VALUE_CODES)})")
        _need(tuple(t.b2_vals.shape) == tuple(t.b2_cols.shape) and t.pa_aval.shape == t.pa_b2row.shape,
              what, "b2_vals must match b2_cols and pa_aval pa_b2row")
        a_code, b_code = _VALUE_CODES[t.pa_aval.dtype], _VALUE_CODES[t.b2_vals.dtype]
    vec4 = int(W % 4 == 0 and t.b2_cols.data_ptr() % 16 == 0)
    return (t.b2_cols.data_ptr(), None if pattern else _ptr(t.b2_vals), b_code, t.pa_b2row.data_ptr(),
            None if pattern else _ptr(t.pa_aval), a_code, t.rowmeta.data_ptr(), t.pa_b2row.shape[0],
            t.b2_cols.shape[0], start, count, R_pad, L, W, vec4)


def _acc(accum_dtype, what: str) -> torch.dtype:
    acc = _torch_dtype(accum_dtype)
    if acc not in _ACC_CODES:
        raise TypeError(f"{what}: accum_dtype {acc} not supported (float32, float64)")
    return acc


def _merged(R_pad: int, L: int, acc, dev):
    return (torch.empty((R_pad, L), dtype=torch.int32, device=dev),
            torch.empty((R_pad, L), dtype=acc, device=dev),
            torch.empty((R_pad,), dtype=torch.int32, device=dev))


def _launch_fetch(t, start, count, L, R_pad, W, accum_dtype, pattern):
    what = "slab_fetch"
    acc = _acc(accum_dtype, what)
    args = _table_args(t, start, count, R_pad, L, W, pattern, what)
    dev = t.rowmeta.device
    col = torch.empty((R_pad, L), dtype=torch.int32, device=dev)
    val = None if pattern else torch.empty((R_pad, L), dtype=acc, device=dev)
    so = kernels.lib()
    err = so.slab_fetch_launch(*args, _ACC_CODES[acc], int(pattern), col.data_ptr(), _ptr(val),
                               kernels.stream_ptr(dev))
    kernels.check(err, what)
    slab_launches["fetch"] += 1
    return col, val


def _launch_fetch_merge(t, start, count, L, R_pad, W, accum_dtype, pattern):
    what = "slab_fetch_merge"
    acc = _acc(accum_dtype, what)
    lay = tile_layout(L, R_pad, acc, pattern)
    args = _table_args(t, start, count, R_pad, L, W, pattern, what)
    dev = t.rowmeta.device
    cols_u, vals_u, nuniq = _merged(R_pad, L, acc, dev)
    so = kernels.lib()
    err = so.slab_fetch_merge_launch(*args, _ACC_CODES[acc], int(pattern), lay.lp.bit_length() - 1, lay.rows,
                                     lay.threads, lay.smem, cols_u.data_ptr(), vals_u.data_ptr(),
                                     nuniq.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, what)
    slab_launches["fetch_merge"] += 1
    return cols_u, vals_u, nuniq


def _launch_merge(col, val, accum_dtype, pattern):
    what = "slab_merge"
    acc = _acc(accum_dtype, what)
    _need(col.dtype == torch.int32 and col.dim() == 2 and col.is_contiguous(), what,
          "col must be a contiguous (R_pad, L) int32 slab")
    R_pad, L = col.shape
    if not pattern:
        _need(val is not None and val.dtype == acc and tuple(val.shape) == (R_pad, L) and val.is_contiguous()
              and val.device == col.device, what, f"val must be a contiguous (R_pad, L) {acc} slab beside col")
    lay = tile_layout(L, R_pad, acc, pattern)
    cols_u, vals_u, nuniq = _merged(R_pad, L, acc, col.device)
    if R_pad == 0:
        return cols_u, vals_u, nuniq
    so = kernels.lib()
    err = so.slab_merge_launch(col.data_ptr(), None if pattern else val.data_ptr(), R_pad, L, _ACC_CODES[acc],
                               int(pattern), lay.lp.bit_length() - 1, lay.rows, lay.threads, lay.smem,
                               cols_u.data_ptr(), vals_u.data_ptr(), nuniq.data_ptr(),
                               kernels.stream_ptr(col.device))
    kernels.check(err, what)
    slab_launches["merge"] += 1
    return cols_u, vals_u, nuniq


def _launch_compact(outs, nrow: int, nnz_pad: int, dtype, device):
    global compact_launches
    what = "slab_compact"
    acc = _acc(dtype, what)
    indptr = _row_offsets(outs, nrow, device)
    data = torch.zeros(nnz_pad, dtype=acc, device=device)
    indices = torch.zeros(nnz_pad, dtype=torch.int32, device=device)
    so = None
    for r, cols_u, vals_u, nu in outs:
        R_pad, L = cols_u.shape
        _need(all(x.device == indptr.device and x.is_contiguous() for x in (r, cols_u, vals_u, nu)), what,
              f"chunk outputs must be contiguous tensors on {indptr.device}")
        _need(r.dtype == torch.int32 and cols_u.dtype == torch.int32 and nu.dtype == torch.int32
              and r.shape == (R_pad,) and nu.shape == (R_pad,) and tuple(vals_u.shape) == (R_pad, L), what,
              "rows, nuniq (R_pad,) and cols_u (R_pad, L) must be int32, vals_u (R_pad, L)")
        if vals_u.dtype != acc:
            raise TypeError(f"{what}: chunk values are {vals_u.dtype}, the CSR's data {acc}")
        so = so or kernels.lib()
        err = so.slab_compact_launch(r.data_ptr(), cols_u.data_ptr(), vals_u.data_ptr(), nu.data_ptr(), R_pad,
                                     L, indptr.data_ptr(), nrow, nnz_pad, _ACC_CODES[acc], _ptr(data),
                                     _ptr(indices), kernels.stream_ptr(device))
        kernels.check(err, what)
        compact_launches += 1
    return data, indices, indptr.to(torch.int32), indptr[-1]


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------


def chunk_fetch(t, start: int, count: int, *, L: int, R_pad: int, W: int, accum_dtype, pattern: bool):
    """K4 (a): one chunk's (col, val) slab from the tables ``t`` (a
    ``_Tables`` or ``SpgemmPlan``): rows [start, start + R_pad) of the class
    order, the first ``count`` live; val is None in pattern mode."""
    if _on_card(t.rowmeta, "slab_fetch"):
        return _launch_fetch(t, start, count, L, R_pad, W, accum_dtype, pattern)
    base, bm = _chunk_meta(t.rowmeta, start, count, R_pad, L // W)
    return _chunk_fetch(t, base, bm, L=L, R_pad=R_pad, W=W, accum_dtype=accum_dtype, pattern=pattern)


def chunk_merge(t, start: int, count: int, *, L: int, R_pad: int, W: int, accum_dtype, pattern: bool):
    """K4 (b): one chunk fetched and merged, ``(cols_u, vals_u, nuniq)``."""
    if _on_card(t.rowmeta, "slab_fetch_merge"):
        return _launch_fetch_merge(t, start, count, L, R_pad, W, accum_dtype, pattern)
    base, bm = _chunk_meta(t.rowmeta, start, count, R_pad, L // W)
    col, val = _chunk_fetch(t, base, bm, L=L, R_pad=R_pad, W=W, accum_dtype=accum_dtype, pattern=pattern)
    return _merge_block(col, val, accum_dtype=accum_dtype, pattern=pattern)


def slab_merge(col, val, *, accum_dtype, pattern: bool):
    """K4 (c): the merge of a cached (R_pad, L) slab, ``(cols_u, vals_u,
    nuniq)``; val is None in pattern mode."""
    if _on_card(col, "slab_merge"):
        return _launch_merge(col, val, accum_dtype, pattern)
    return _merge_block(col, val, accum_dtype=accum_dtype, pattern=pattern)


def compact_to_csr(outs, *, nrow: int, nnz_pad: int, dtype, device):
    """K5: chunk outputs ``(rows, cols_u, vals_u, nuniq)`` → device CSR
    arrays (data, indices, indptr int32, nnz as a 0-d tensor), as
    :func:`_compact_to_csr`.  The row counts and indptr are torch ops
    (nrow-sized); each chunk's rows are copied by one launch."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return _compact_to_csr(outs, nrow=nrow, nnz_pad=nnz_pad, dtype=dtype, device=dev)
    if dev.type != "cuda":
        raise ValueError(f"slab_compact: unsupported device {dev}")
    return _launch_compact(outs, nrow, nnz_pad, dtype, dev)
