"""K2 — ELL slabs times a dense matrix: the CUDA kernel
``csrc/ell_slab_spmm.cu``, its plain PyTorch version, its work table, and the
wrappers that pick between kernel and plain version by the tensors' device.

``ell_slabs_spmm`` multiplies a list of slabs in one launch, slab s writing
rows ``row0_s .. row0_s + R_s`` of one output; ``ell_slab_spmm`` is the
one-slab call of the same kernel.  The launch follows a work table
(:func:`work_table`) built on the host once per pack and lane layout, and
memoized on the container that holds the slabs (:func:`table_memo`).

Replaces the Pallas TPU kernel ``spmm_tpu/ops/pallas_ell.py:
ell_slab_octets_pallas`` (reached by ``ell_slab_spmm_pallas``) and the XLA
per-slab sum of ``spmm_tpu/ops/ell_spmm.py: _slab_loop``.  The kernel's header
says what bounds it on the card and how its design answers that.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmm_tpu_torch import kernels
from spmm_tpu_torch.formats.containers import as_tensor, memo_of

#: CUDA launches of K2 in this process (chip_smoke.py resets and reads it)
launches = 0

_DTYPES = {torch.float32: kernels.F32, torch.bfloat16: kernels.BF16}

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


def ell_slab_spmm_reference(cols: torch.Tensor, data: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``Y[r] = Σ_e data[r, e] · B[clip(cols[r, e]), :]`` in
    fp32, for cols/data (R, L) and B (n, k)."""
    c = cols.long().clamp(0, B.shape[0] - 1)
    return (data.float()[..., None] * B[c].float()).sum(1)


def lane_layout(k: int, aligned: bool) -> tuple[int, int]:
    """``(vec, tpr_log2)``: columns per lane (4 when k % 4 == 0 and B and the
    output are 16-byte aligned, else 1) and log2 of the lanes that share one
    row (the smallest power of two covering k / vec, at most a warp)."""
    vec = 4 if k % 4 == 0 and aligned else 1
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
    (pointers, then ``meta``), the items, and the slab tensors whose
    pointers it holds (kept alive with it)."""

    slabs: torch.Tensor
    items: torch.Tensor
    data_code: int
    keep: tuple


def table_memo(owner) -> dict | None:
    """The dict on ``owner`` (an ELL, a slab view) that memoizes its work
    tables, keyed by device and lane layout (:func:`memo_of`)."""
    return memo_of(owner, "_k2_tables")


def _slab_table(cols, data, device, tpr_log2: int, row_keys=None, split_l: int = SPLIT_L) -> SlabTable:
    cols = [as_tensor(c, device) for c in cols]
    data = [as_tensor(d, device) for d in data]
    dtypes = {d.dtype for d in data}
    if len(dtypes) > 1 or not dtypes <= set(_DTYPES):
        raise TypeError(f"ell_slabs_spmm: slab data {sorted(map(str, dtypes))} not one dtype of "
                        "float32, bfloat16")
    for c, d in zip(cols, data, strict=True):
        if c.dtype != torch.int32:
            raise TypeError(f"ell_slabs_spmm: cols must be int32, got {c.dtype}")
        if c.dim() != 2 or d.shape != c.shape:
            raise ValueError(f"ell_slabs_spmm: data {tuple(d.shape)} != cols {tuple(c.shape)}")
        if c.shape[1] < 1:
            raise ValueError("ell_slabs_spmm: needs L >= 1")
        if not (c.is_contiguous() and d.is_contiguous()):
            raise ValueError("ell_slabs_spmm: slabs must be contiguous")
    if callable(row_keys):
        row_keys = row_keys()
    meta, items = work_table([(c.shape[0], c.shape[1]) for c in cols], tpr_log2, row_keys=row_keys,
                             split_l=split_l)
    host = np.zeros((len(cols), SLAB_FIELDS), np.int64)
    host[:, 0] = [c.data_ptr() for c in cols]
    host[:, 1] = [d.data_ptr() for d in data]
    host[:, 2:] = meta
    return SlabTable(
        slabs=torch.from_numpy(host).to(device),
        items=torch.from_numpy(items).to(device),
        data_code=_DTYPES[data[0].dtype] if data else kernels.F32,
        keep=(cols, data),
    )


def ell_slabs_spmm_reference(cols, data, B: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`ell_slabs_spmm`: each slab's
    :func:`ell_slab_spmm_reference` into its rows of ``out``."""
    row = 0
    for c, d in zip(cols, data):
        c, d = as_tensor(c, B.device), as_tensor(d, B.device)
        out[row : row + c.shape[0]] = ell_slab_spmm_reference(c, d, B)
        row += c.shape[0]
    return out


def ell_slabs_spmm(cols, data, B: torch.Tensor, out: torch.Tensor | None = None, *,
                   memo: dict | None = None, row_keys=None) -> torch.Tensor:
    """(ΣR, k) fp32: the slabs ``(cols[s], data[s])`` (R_s, L_s) times B (n,
    k), slab s in rows ``Σ_{t<s} R_t ..`` of ``out`` (allocated when not
    given).  CPU tensors take the plain version; for CUDA tensors this is ONE
    launch of K2, and anything K2 does not take raises.  ``memo``: a dict
    (:func:`table_memo`) that keeps the work table across calls on the same
    slabs, which must then not change; slabs held elsewhere than B are copied
    to B's device once and kept with the table.  ``row_keys``: the order of
    the work items (:func:`work_table`), or a function that returns it;
    read only when the table is built."""
    global launches
    if B.dim() != 2:
        raise ValueError("ell_slabs_spmm: B must be (n, k)")
    dev, k = B.device, B.shape[1]
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ell_slabs_spmm: unsupported device {dev}")
    if dev.type == "cuda":
        if B.dtype not in _DTYPES:
            raise TypeError(f"ell_slabs_spmm: B {B.dtype} not supported (float32, bfloat16)")
        if not B.is_contiguous():
            raise ValueError("ell_slabs_spmm: B must be contiguous")
        if B.shape[0] < 1:
            raise ValueError("ell_slabs_spmm: needs n >= 1")
    rows = sum(int(c.shape[0]) for c in cols)
    if out is None:
        out = torch.empty((rows, k), dtype=torch.float32, device=dev)
    elif tuple(out.shape) != (rows, k):
        raise ValueError(f"ell_slabs_spmm: out {tuple(out.shape)} != {(rows, k)}")
    if dev.type == "cpu":
        return ell_slabs_spmm_reference(cols, data, B, out)
    if out.device != dev or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError("ell_slabs_spmm: out must be a contiguous float32 tensor on B's device")
    vec, tpr_log2 = lane_layout(k, B.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    key = (dev, tpr_log2)
    table = memo.get(key) if memo is not None else None
    if table is None:
        table = _slab_table(cols, data, dev, tpr_log2, row_keys)
        if memo is not None:
            memo[key] = table
    if rows == 0 or k == 0:
        return out
    launches += 1
    err = kernels.lib().ell_slabs_spmm_launch(
        table.slabs.data_ptr(), table.items.data_ptr(), table.items.shape[0], table.data_code,
        B.data_ptr(), _DTYPES[B.dtype], out.data_ptr(), B.shape[0], k, vec, tpr_log2,
        kernels.stream_ptr(dev),
    )
    kernels.check(err, "ell_slabs_spmm")
    return out


def ell_slab_spmm(
    cols: torch.Tensor, data: torch.Tensor, B: torch.Tensor, *, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Y (R, k) fp32 for one (R, L) slab; written into ``out`` (an (R, k)
    fp32 tensor, e.g. a row range of the sorted output) when given.  The
    one-slab call of :func:`ell_slabs_spmm` (its work table is built per
    call)."""
    if cols.dim() != 2:
        raise ValueError("ell_slab_spmm: cols must be (R, L)")
    if B.device.type == "cuda":
        for name, t in (("cols", cols), ("data", data)):
            if t.device != B.device:
                raise ValueError(f"ell_slab_spmm: {name} on {t.device}, B on {B.device}")
    return ell_slabs_spmm((cols,), (data,), B, out)
