"""K4 and K5: the slab SpGEMM's numeric phase on hand-written kernels
(``csrc/slab_spgemm.cu``), and their plain PyTorch versions.

Over the class chunks of (R_pad, L) partial-product slots of one product
(``ops/slab_spgemm.py``):

- :func:`chunk_fetch_all` (K4 a): every chunk's slab, (R_pad, L) columns
  with ``_INT_MAX`` pads and the partial products in ``accum_dtype`` (the
  class-aligned cache of ``spgemm_plan(expand=True)``), views of one
  allocation laid out by :func:`fetch_plan`; plain version
  :func:`_chunk_fetch`, to which the kernel is bit-identical.
  :func:`chunk_fetch` is one chunk of it.
- :func:`chunk_merge_all` (K4 b): every chunk of a product made in shared
  memory and merged at once, never written out: ``(cols_u, vals_u,
  nuniq)`` per chunk; plain version :func:`_merge_block` of
  :func:`_chunk_fetch`.  :func:`chunk_merge` is one chunk of it.
- :func:`slab_merge_all` (K4 c): the same merge of cached slabs; plain
  version :func:`_merge_block`.  :func:`slab_merge` is one slab of it.
- :func:`compact_to_csr` (K5): the chunks' merged rows as device CSR arrays;
  plain version :func:`_compact_to_csr`.

A plan's fetch is one launch (per :data:`MAX_LAUNCH_CHUNKS` chunks) over a
chunk table the host builds (:func:`fetch_plan`), a product's merge one
launch per block-size group of its chunks (:data:`MERGE_GROUPS`: at most
three, :func:`merge_plan`); the chunks' outputs are views of one
allocation.

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

#: K4 launches in this process by entry (a, b, c): (a) one per plan (per
#: MAX_LAUNCH_CHUNKS chunks), (b) and (c) one per block-size group of a
#: product's chunks; K5 launches, one
#: per product (its count and copy passes) (chip_smoke.py resets and reads
#: them)
slab_launches = {"fetch": 0, "fetch_merge": 0, "merge": 0}
compact_launches = 0

#: the merge kernel's block sizes, by the widest row each takes: (widest L,
#: threads, consecutive slots per thread); a tile (a CTA) holds threads *
#: slots slots, rows of L unpadded, T // L of them
MERGE_GROUPS = ((2048, 256, 8), (4096, 512, 8), (16384, 1024, 16))

#: the widest class (slots per row) the merge takes: a row sorts in one CTA's
#: shared memory, 14 B per slot in fp64 (a 4-byte column, a 2-byte run
#: start, the value), 229,376 B at 16,384 slots of the 232,448 a CTA may use
MAX_L = MERGE_GROUPS[-1][0]

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

#: the int64 fields of a merge launch's chunk table, one row per chunk (the
#: kernel's MergeField): (c) the slab's column and value pointers, (b) the
#: chunk's first row in rowmeta and its live rows, R_pad, L, the chunk's first
#: output slot and row, its first tile in the launch, rows per tile
MERGE_FIELDS = ("col_ptr", "val_ptr", "start", "count", "R_pad", "L", "out_slot", "out_row", "tile0", "rows_t")

#: the int64 fields of K4 (a)'s chunk table (the kernel's FetchField): the
#: chunk's first slot in the outputs, its first piece (four slots) in the
#: launch, its first row in rowmeta, its live rows, R_pad, L
FETCH_FIELDS = ("out_slot", "piece0", "start", "count", "R_pad", "L")

#: slots a fetch piece holds: 16 bytes of int32 columns
FETCH_PIECE = 4

#: the int64 fields of K5's chunk table (the kernel's CompactField): the
#: pointers of rows, cols_u, vals_u and nuniq, R_pad, L, the chunk's first
#: row and first slot over the launch's chunks
COMPACT_FIELDS = ("rows_ptr", "cols_ptr", "vals_ptr", "nu_ptr", "R_pad", "L", "row0", "slot0")

#: chunks one launch takes: a launch's chunk table is a kernel parameter (the
#: kernel's kMaxChunks), so a group of more chunks takes more launches
MAX_LAUNCH_CHUNKS = 64


@dataclasses.dataclass(frozen=True)
class FetchLaunch:
    """One launch of the fetch kernel over the chunks ``chunks`` (indices
    into the schedule) whose ``pieces`` pieces ``table`` ((len(chunks), 6)
    int64, :data:`FETCH_FIELDS`) numbers."""

    chunks: tuple
    pieces: int
    table: np.ndarray


@dataclasses.dataclass(frozen=True)
class FetchPlan:
    """A plan's fetch launches (one per ``MAX_LAUNCH_CHUNKS`` chunks with
    slots) and where each chunk's slab lies in the one allocation of
    ``slots`` slots: at ``slot_off``, a multiple of :data:`FETCH_PIECE`
    (16-byte aligned for int32 and fp32, 32 for fp64), so that every view
    takes 16-byte stores and K4 (c)'s 16-byte loads."""

    launches: tuple
    slot_off: tuple
    slots: int
    rows_end: int  #: the rows of rowmeta the chunks reach, max(start + R_pad)


def _launch_parts(idx):
    """The chunk indices ``idx`` cut into launches of at most
    :data:`MAX_LAUNCH_CHUNKS` (a kernel's chunk table holds no more)."""
    return [idx[k : k + MAX_LAUNCH_CHUNKS] for k in range(0, len(idx), MAX_LAUNCH_CHUNKS)]


def fetch_plan(sched, W: int) -> FetchPlan:
    """K4 (a)'s layout and launches for the chunks ``(L, R_pad, start,
    count)`` of ``sched``: each chunk's slab after the previous one's,
    rounded up to a whole piece; a chunk's pieces numbered on from the
    previous chunk's in its launch (the last one partial where R_pad * L is
    no multiple of 4).  Raises ValueError on a chunk the kernel does not
    take (L no multiple of ``W``, count outside [0, R_pad], a negative
    start)."""
    what = "slab_fetch"
    for L, R_pad, start, count in sched:
        if L < 1 or L % W:
            raise ValueError(f"{what}: L={L} must be a multiple of W={W}")
        if not 0 <= count <= R_pad:
            raise ValueError(f"{what}: count={count} must lie in [0, R_pad={R_pad}]")
        if start < 0:
            raise ValueError(f"{what}: chunk rows [{start}, {start + R_pad}) start before the plan's first row")
    L, R, start, count = np.array(sched, np.int64).reshape(len(sched), 4).T
    own = -(-L * R // FETCH_PIECE)
    slot_off = (np.cumsum(own) - own) * FETCH_PIECE
    full = np.stack([slot_off, own, start, count, R, L], 1)  # FETCH_FIELDS, own pieces in piece0's place
    launches = []
    for part in _launch_parts(np.flatnonzero(own)):
        table, pieces = full[part], own[part]
        table[:, 1] = np.cumsum(pieces) - pieces
        launches.append(FetchLaunch(chunks=tuple(part.tolist()), pieces=int(pieces.sum()), table=table))
    return FetchPlan(launches=tuple(launches), slot_off=tuple(slot_off.tolist()),
                     slots=int(own.sum()) * FETCH_PIECE, rows_end=int((start + R).max(initial=0)))


def merge_group(L: int) -> int:
    """The block-size group (index into :data:`MERGE_GROUPS`) of a class of
    ``L`` slots per row; ValueError above ``MAX_L``."""
    for g, (widest, _, _) in enumerate(MERGE_GROUPS):
        if 1 <= L <= widest:
            return g
    raise ValueError(f"slab merge kernel: a class of {L} slots per row is above its limit of "
                     f"{MAX_L} (MAX_L); use classes up to {MAX_L}")


@dataclasses.dataclass(frozen=True)
class MergeLaunch:
    """One launch of the merge kernel: ``tiles`` CTAs of ``threads`` threads,
    ``items`` consecutive slots each, over the product's chunks ``chunks``
    (indices into its chunk list) whose rows ``table`` ((len(chunks), 10)
    int64, :data:`MERGE_FIELDS`) cuts into tiles; ``rows_cap`` the most rows
    a tile holds, ``smem`` bytes of dynamic shared memory."""

    group: int
    threads: int
    items: int
    chunks: tuple
    tiles: int
    rows_cap: int
    smem: int
    table: np.ndarray

    @property
    def slots(self) -> int:
        return self.threads * self.items


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """A product's merge launches (one per block-size group its chunks use,
    more where a group has more than ``MAX_LAUNCH_CHUNKS`` chunks) and where
    each chunk's outputs lie in the one allocation: ``slot_off`` in cols_u /
    vals_u, ``row_off`` in nuniq, ``slots`` / ``rows`` in all."""

    launches: tuple
    slot_off: tuple
    row_off: tuple
    slots: int
    rows: int


def merge_smem(group: int, accum_dtype, rows_cap: int) -> int:
    """Dynamic shared memory of a merge tile: per slot the value (in pattern
    mode the output count), the column and a 16-bit run start; three int
    arrays of rows_cap + 1 and 33 ints for the scans."""
    _, threads, items = MERGE_GROUPS[group]
    return threads * items * (_torch_dtype(accum_dtype).itemsize + 4 + 2) + 12 * (rows_cap + 1) + 4 * 33


def merge_plan(shapes, accum_dtype, *, starts=None, counts=None, col_ptrs=None, val_ptrs=None) -> MergePlan:
    """The merge launches of a product's chunks ``shapes`` ((L, R_pad) each):
    per block-size group, a tile of T = threads * items slots takes T // L
    consecutive rows of one chunk (the last tile of a chunk fewer), and the
    table gives each chunk its first tile.  (b) passes each chunk's
    ``starts`` / ``counts``, (c) its slabs' ``col_ptrs`` / ``val_ptrs``."""
    acc = _acc(accum_dtype, "slab merge kernel")
    n = len(shapes)
    L = np.array([x[0] for x in shapes], np.int64).reshape(n)
    R = np.array([x[1] for x in shapes], np.int64).reshape(n)
    group = np.array([merge_group(int(x)) if r > 0 else -1 for x, r in zip(L, R)], np.int64)  # raises above MAX_L
    slot_off = np.cumsum(L * R) - L * R
    row_off = np.cumsum(R) - R
    tab = np.zeros((n, len(MERGE_FIELDS)), np.int64)
    for f, v in (("col_ptr", col_ptrs), ("val_ptr", val_ptrs), ("start", starts), ("count", R if counts is None
                 else counts), ("R_pad", R), ("L", L), ("out_slot", slot_off), ("out_row", row_off)):
        if v is not None:
            tab[:, MERGE_FIELDS.index(f)] = [0 if x is None else x for x in v]
    launches = []
    for g, (_, threads, items) in enumerate(MERGE_GROUPS):
        idx = np.nonzero(group == g)[0]
        for part in _launch_parts(idx):
            t = tab[part]
            rows_t = np.minimum(threads * items // L[part], R[part])
            tiles = -(-R[part] // rows_t)
            t[:, MERGE_FIELDS.index("tile0")] = np.cumsum(tiles) - tiles
            t[:, MERGE_FIELDS.index("rows_t")] = rows_t
            rows_cap = int(rows_t.max())
            launches.append(MergeLaunch(group=g, threads=threads, items=items, chunks=tuple(int(i) for i in part),
                                        tiles=int(tiles.sum()), rows_cap=rows_cap, smem=merge_smem(g, acc, rows_cap),
                                        table=np.ascontiguousarray(t)))
    return MergePlan(launches=tuple(launches), slot_off=tuple(int(x) for x in slot_off),
                     row_off=tuple(int(x) for x in row_off), slots=int((L * R).sum()), rows=int(R.sum()))


def compact_plan(shapes):
    """K5's launches over the chunk outputs' ``shapes`` ((L, R_pad) each):
    per launch of up to ``MAX_LAUNCH_CHUNKS`` chunks (those with rows and
    slots) its chunk table (pointers filled by the caller,
    :data:`COMPACT_FIELDS`), its chunks, their rows and their slots:
    ``[(table, chunks, rtot, stot), ...]``.  Slot e of chunk row i is the
    launch's slot slot0 + i * L + e."""
    idx = [i for i, (L, R_pad) in enumerate(shapes) if L > 0 and R_pad > 0]
    out = []
    for part in _launch_parts(idx):
        tab = np.zeros((len(part), len(COMPACT_FIELDS)), np.int64)
        rtot = stot = 0
        for k, i in enumerate(part):
            L, R_pad = shapes[i]
            tab[k, 4:] = (R_pad, L, rtot, stot)
            rtot += R_pad
            stot += R_pad * L
        out.append((tab, part, rtot, stot))
    return out


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


def _table_args(t, W: int, pattern: bool, what: str):
    """The C entries' product-table arguments, after the checks the kernels
    rely on: (b2_cols, b2_vals, b_code, pa_b2row, pa_aval, a_code, rowmeta,
    npa_pad, nseg_pad, W, vec4)."""
    dev = t.rowmeta.device
    tabs = [t.b2_cols, t.pa_b2row, t.rowmeta] + ([] if pattern else [t.b2_vals, t.pa_aval])
    _need(all(isinstance(x, torch.Tensor) and x.device == dev and x.is_contiguous() for x in tabs), what,
          f"the tables must be contiguous tensors on {dev}")
    _need(t.b2_cols.dtype == torch.int32 and t.b2_cols.dim() == 2 and t.b2_cols.shape[1] == W, what,
          f"b2_cols must be (nsegB_pad, {W}) int32")
    _need(t.pa_b2row.dtype == torch.int32 and t.rowmeta.dtype == torch.int32
          and t.rowmeta.dim() == 2 and t.rowmeta.shape[1] == 2, what,
          "pa_b2row and rowmeta (nrow_pad, 2) must be int32")
    _need(W >= 1 and t.b2_cols.shape[0] >= 1 and t.pa_b2row.shape[0] >= 1, what,
          f"W={W} must be positive, over non-empty tables")
    a_code = b_code = 0
    if not pattern:
        for x, name in ((t.b2_vals, "b2_vals"), (t.pa_aval, "pa_aval")):
            if x.dtype not in _VALUE_CODES:
                raise TypeError(f"{what}: {name} dtype {x.dtype} not supported "
                                f"({', '.join(str(d) for d in _VALUE_CODES)})")
        _need(tuple(t.b2_vals.shape) == tuple(t.b2_cols.shape) and t.pa_aval.shape == t.pa_b2row.shape,
              what, "b2_vals must match b2_cols and pa_aval pa_b2row")
        a_code, b_code = _VALUE_CODES[t.pa_aval.dtype], _VALUE_CODES[t.b2_vals.dtype]
    vec4 = int(W % 4 == 0 and t.b2_cols.data_ptr() % 16 == 0 and (pattern or t.b2_vals.data_ptr() % 16 == 0))
    return (t.b2_cols.data_ptr(), None if pattern else _ptr(t.b2_vals), b_code, t.pa_b2row.data_ptr(),
            None if pattern else _ptr(t.pa_aval), a_code, t.rowmeta.data_ptr(), t.pa_b2row.shape[0],
            t.b2_cols.shape[0], W, vec4)


def _check_chunk(t, start: int, count: int, R_pad: int, L: int, W: int, what: str) -> None:
    _need(L >= 1 and L % W == 0, what, f"L={L} must be a multiple of W={W}")
    _need(R_pad >= 0 and 0 <= count <= R_pad, what, f"count={count} must lie in [0, R_pad={R_pad}]")
    if start < 0 or start + R_pad > t.rowmeta.shape[0]:
        raise ValueError(f"chunk rows [{start}, {start + R_pad}) run past the plan's padding")


def _acc(accum_dtype, what: str) -> torch.dtype:
    acc = _torch_dtype(accum_dtype)
    if acc not in _ACC_CODES:
        raise TypeError(f"{what}: accum_dtype {acc} not supported (float32, float64)")
    return acc


def _fetch_views(fp: FetchPlan, sched, col_all, val_all):
    """Each chunk's ``(col, val)`` views into the one allocation of a fetch
    (columns; values, or None in pattern mode)."""
    return [(col_all.as_strided((R_pad, L), (L, 1), o),
             None if val_all is None else val_all.as_strided((R_pad, L), (L, 1), o))
            for (L, R_pad, _, _), o in zip(sched, fp.slot_off)]


def _launch_fetch_all(t, sched, W, accum_dtype, pattern):
    what = "slab_fetch"
    acc = _acc(accum_dtype, what)
    args = _table_args(t, W, pattern, what)
    fp = fetch_plan(sched, W)
    if fp.rows_end > t.rowmeta.shape[0]:
        raise ValueError(f"chunk rows up to {fp.rows_end} run past the plan's padding ({t.rowmeta.shape[0]} rows)")
    dev = t.rowmeta.device
    col_all = torch.empty(fp.slots, dtype=torch.int32, device=dev)
    val_all = None if pattern else torch.empty(fp.slots, dtype=acc, device=dev)
    for x in fp.launches:
        err = kernels.lib().slab_fetch_launch(*args, x.table.ctypes.data, len(x.chunks), x.pieces, _ACC_CODES[acc],
                                              int(pattern), col_all.data_ptr(), _ptr(val_all),
                                              kernels.stream_ptr(dev))
        kernels.check(err, what)
        slab_launches["fetch"] += 1
    return _fetch_views(fp, sched, col_all, val_all)  # made while the kernel runs


def _launch_merges(plan: MergePlan, shapes, acc, pattern: bool, dev, table_args, entry: str, what: str):
    """Every launch of ``plan``: the outputs of all chunks in one allocation,
    returned as each chunk's (cols_u, vals_u, nuniq) views."""
    cols_all = torch.empty(plan.slots, dtype=torch.int32, device=dev)
    vals_all = torch.empty(plan.slots, dtype=acc, device=dev)
    nu_all = torch.empty(plan.rows, dtype=torch.int32, device=dev)
    for x in plan.launches:
        err = kernels.lib().slab_merge_launch(*table_args, x.table.ctypes.data, len(x.chunks), x.tiles, x.group,
                                              x.rows_cap, x.smem, _ACC_CODES[acc], int(pattern), cols_all.data_ptr(),
                                              vals_all.data_ptr(), nu_all.data_ptr(), kernels.stream_ptr(dev))
        kernels.check(err, what)
        slab_launches[entry] += 1
    sizes = [L * R_pad for L, R_pad in shapes]
    return [(c.view(R_pad, L), v.view(R_pad, L), nu)
            for c, v, nu, (L, R_pad) in zip(cols_all.split(sizes), vals_all.split(sizes),
                                            nu_all.split([R_pad for _, R_pad in shapes]), shapes)]


def _launch_chunk_merges(t, sched, W, accum_dtype, pattern):
    what = "slab_fetch_merge"
    acc = _acc(accum_dtype, what)
    args = _table_args(t, W, pattern, what)
    for L, R_pad, start, count in sched:
        _check_chunk(t, start, count, R_pad, L, W, what)
    shapes = [(L, R_pad) for L, R_pad, _, _ in sched]
    plan = merge_plan(shapes, acc, starts=[s for _, _, s, _ in sched], counts=[c for _, _, _, c in sched])
    return _launch_merges(plan, shapes, acc, pattern, t.rowmeta.device, args, "fetch_merge", what)


def _launch_slab_merges(cols, vals, accum_dtype, pattern):
    what = "slab_merge"
    acc = _acc(accum_dtype, what)
    dev = cols[0].device
    for i, col in enumerate(cols):
        _need(col.dtype == torch.int32 and col.dim() == 2 and col.is_contiguous() and col.device == dev, what,
              "each col must be a contiguous (R_pad, L) int32 slab, all on one device")
        if not pattern:
            val = vals[i]
            _need(val is not None and val.dtype == acc and val.shape == col.shape and val.is_contiguous()
                  and val.device == dev, what, f"each val must be a contiguous (R_pad, L) {acc} slab beside col")
    shapes = [(col.shape[1], col.shape[0]) for col in cols]
    plan = merge_plan(shapes, acc, col_ptrs=[c.data_ptr() for c in cols],
                      val_ptrs=None if pattern else [v.data_ptr() for v in vals])
    no_tables = (None, None, 0, None, None, 0, None, 0, 0, 0, 0)
    return _launch_merges(plan, shapes, acc, pattern, dev, no_tables, "merge", what)


def _launch_compact(outs, nrow: int, nnz_pad: int, dtype, device):
    global compact_launches
    what = "slab_compact"
    acc = _acc(dtype, what)
    device = torch.empty(0, device=device).device  # with its index
    for r, cols_u, vals_u, nu in outs:
        R_pad, L = cols_u.shape
        _need(all(x.device == device and x.is_contiguous() for x in (r, cols_u, vals_u, nu)), what,
              f"chunk outputs must be contiguous tensors on {device}")
        _need(r.dtype == torch.int32 and cols_u.dtype == torch.int32 and nu.dtype == torch.int32
              and r.shape == (R_pad,) and nu.shape == (R_pad,) and tuple(vals_u.shape) == (R_pad, L), what,
              "rows, nuniq (R_pad,) and cols_u (R_pad, L) must be int32, vals_u (R_pad, L)")
        if vals_u.dtype != acc:
            raise TypeError(f"{what}: chunk values are {vals_u.dtype}, the CSR's data {acc}")
    parts = compact_plan([tuple(o[1].shape[::-1]) for o in outs])
    for tab, idx, _, _ in parts:
        for k, i in enumerate(idx):
            tab[k, :4] = [x.data_ptr() for x in outs[i]]
    so = kernels.lib()
    stream = kernels.stream_ptr(device)
    counts = torch.zeros(nrow, dtype=torch.int32, device=device)
    for tab, idx, rtot, _ in parts:
        kernels.check(so.slab_compact_counts_launch(tab.ctypes.data, len(idx), rtot, nrow, _ptr(counts), stream),
                      what)
    indptr = torch.zeros(nrow + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=indptr[1:])
    data = torch.empty(nnz_pad, dtype=acc, device=device)
    indices = torch.empty(nnz_pad, dtype=torch.int32, device=device)
    empty = np.zeros((0, len(COMPACT_FIELDS)), np.int64)
    for k, (tab, idx, _, stot) in enumerate(parts or [(empty, [], 0, 0)]):
        err = so.slab_compact_launch(tab.ctypes.data, len(idx), stot, indptr.data_ptr(), nrow, nnz_pad,
                                     int(k == max(len(parts) - 1, 0)), _ACC_CODES[acc], _ptr(data), _ptr(indices),
                                     stream)
        kernels.check(err, what)
    compact_launches += 1
    return data, indices, indptr.to(torch.int32), indptr[-1]


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------


def chunk_fetch_all(t, sched, *, W: int, accum_dtype, pattern: bool):
    """K4 (a): the (col, val) slab of every chunk ``(L, R_pad, start,
    count)`` of ``sched`` from the tables ``t`` (a ``_Tables`` or
    ``SpgemmPlan``): rows [start, start + R_pad) of the class order, the
    first ``count`` live; val is None in pattern mode.  The slabs are
    contiguous (R_pad, L) views of one int32 and one ``accum_dtype``
    allocation, each at a 16-byte aligned offset (:func:`fetch_plan`): one
    launch per ``MAX_LAUNCH_CHUNKS`` chunks on the card, ``_chunk_fetch``
    into the same views on the CPU."""
    sched = list(sched)
    if _on_card(t.rowmeta, "slab_fetch"):
        return _launch_fetch_all(t, sched, W, accum_dtype, pattern)
    acc = _acc(accum_dtype, "slab_fetch")
    fp, dev = fetch_plan(sched, W), t.rowmeta.device
    views = _fetch_views(fp, sched, torch.empty(fp.slots, dtype=torch.int32, device=dev),
                         None if pattern else torch.empty(fp.slots, dtype=acc, device=dev))
    for (L, R_pad, start, count), (col, val) in zip(sched, views):
        base, bm = _chunk_meta(t.rowmeta, start, count, R_pad, L // W)
        col_p, val_p = _chunk_fetch(t, base, bm, L=L, R_pad=R_pad, W=W, accum_dtype=acc, pattern=pattern)
        col.copy_(col_p)
        if not pattern:
            val.copy_(val_p)
    return views


def chunk_fetch(t, start: int, count: int, *, L: int, R_pad: int, W: int, accum_dtype, pattern: bool):
    """K4 (a) of one chunk, ``(col, val)``."""
    return chunk_fetch_all(t, [(L, R_pad, start, count)], W=W, accum_dtype=accum_dtype, pattern=pattern)[0]


def chunk_merge_all(t, sched, *, W: int, accum_dtype, pattern: bool):
    """K4 (b): every chunk ``(L, R_pad, start, count)`` of ``sched`` fetched
    from the tables ``t`` and merged, ``(cols_u, vals_u, nuniq)`` per chunk:
    one launch per block-size group on the card."""
    if _on_card(t.rowmeta, "slab_fetch_merge"):
        return _launch_chunk_merges(t, list(sched), W, accum_dtype, pattern)
    outs = []
    for L, R_pad, start, count in sched:
        base, bm = _chunk_meta(t.rowmeta, start, count, R_pad, L // W)
        col, val = _chunk_fetch(t, base, bm, L=L, R_pad=R_pad, W=W, accum_dtype=accum_dtype, pattern=pattern)
        outs.append(_merge_block(col, val, accum_dtype=accum_dtype, pattern=pattern))
    return outs


def chunk_merge(t, start: int, count: int, *, L: int, R_pad: int, W: int, accum_dtype, pattern: bool):
    """K4 (b) of one chunk, ``(cols_u, vals_u, nuniq)``."""
    return chunk_merge_all(t, [(L, R_pad, start, count)], W=W, accum_dtype=accum_dtype, pattern=pattern)[0]


def slab_merge_all(cols, vals, *, accum_dtype, pattern: bool):
    """K4 (c): the merges of cached (R_pad, L) slabs ``cols`` (values
    ``vals``, ignored in pattern mode), ``(cols_u, vals_u, nuniq)`` per slab:
    one launch per block-size group on the card."""
    cols = list(cols)
    vals = [None] * len(cols) if pattern else list(vals)
    if not cols:
        return []
    if _on_card(cols[0], "slab_merge"):
        return _launch_slab_merges(cols, vals, accum_dtype, pattern)
    return [_merge_block(col, val, accum_dtype=accum_dtype, pattern=pattern) for col, val in zip(cols, vals)]


def slab_merge(col, val, *, accum_dtype, pattern: bool):
    """K4 (c) of one cached (R_pad, L) slab, ``(cols_u, vals_u, nuniq)``;
    val is None in pattern mode."""
    return slab_merge_all([col], [val], accum_dtype=accum_dtype, pattern=pattern)[0]


def compact_to_csr(outs, *, nrow: int, nnz_pad: int, dtype, device):
    """K5: chunk outputs ``(rows, cols_u, vals_u, nuniq)`` → device CSR
    arrays (data, indices, indptr int32, nnz as a 0-d tensor), as
    :func:`_compact_to_csr`.  On the card: the count pass, the indptr scan
    (torch) and the copy pass over every chunk, with the padding past nnz
    zeroed."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return _compact_to_csr(outs, nrow=nrow, nnz_pad=nnz_pad, dtype=dtype, device=dev)
    if dev.type != "cuda":
        raise ValueError(f"slab_compact: unsupported device {dev}")
    return _launch_compact(outs, nrow, nnz_pad, dtype, dev)
