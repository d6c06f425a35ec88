"""Row-partitioned SpGEMM over a ``DeviceMesh`` (port of the replicated-B
half of ``spmm_tpu/parallel/spgemm_spmd.py``).

The left matrix is row-block sharded over the mesh's "rows" axis (the
reference's region split is the shard unit, SURVEY.md §2.4/§2.12); B is
replicated on every rank.  Every shard runs the same slab program
(``ops/slab_spgemm.py``) with one chunk schedule: the pa padding is the
maximum over shards, the schedule is built from the per-class maximum row
counts, and each shard gets its own (start, count) per chunk (an empty chunk
only masks).  Every rank sizes all shards on the host, so all ranks hold the
same schedule; each then runs only its own shard through the piece executor
the streamed big path uses (``_piece_exec``), and its heavy-tail rows through
the global-sort ESC.  The compute needs no collective (B replicated, outputs
row-disjoint); the collectives only assemble the result.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from spmm_tpu_torch import native
from spmm_tpu_torch.formats.containers import CSR, as_tensor
from spmm_tpu_torch.ops.slab_spgemm import (
    DEFAULT_CLASSES,
    DEFAULT_SEG_W,
    DEFAULT_SLOT_BUDGET,
    _bucket_pow2,
    _compact_to_csr,
    _is_pattern,
    _norm_classes,
    _piece_csr,
    _piece_exec,
    _piece_kw,
    _round_up,
    _stable_argsort_smallint,
    _tail_pairs,
)
from spmm_tpu_torch.parallel.mesh import axis_size, mesh_device
from spmm_tpu_torch.parallel.partition import ShardedCSR, local_shard


def _per_shard_sizing(S: ShardedCSR, B: CSR, W: int, classes):
    """Host sizing of each shard against one B: (cls (nsh, rows_pad) int32,
    counts (nsh, nclasses + 1) int64, npa_max, nnz (nsh,) int32, npa_body
    (nsh,) int64).  ``npa_body`` counts only the pairs of rows below the
    class ceiling: a tail row goes to the global-sort ESC, so its pairs take
    no slab slots.  Raises ValueError when a shard's padded expansion
    exceeds the int32 range."""
    b_iptr = np.asarray(B.host().indptr, dtype=np.int64)
    lenB = b_iptr[1:] - b_iptr[:-1]
    nsegB_row = (lenB + W - 1) // W
    ind = np.asarray(S.indices)
    iptr = np.asarray(S.indptr, dtype=np.int64)
    classes_np = np.asarray(classes, np.int64)
    tail = len(classes)
    cls_all, counts_all, npa_max, nnz_s, body = [], [], 0, [], []
    for s in range(S.n_shards):
        nnz = int(iptr[s, -1])
        nnz_s.append(nnz)
        res = native.spgemm_sizing(iptr[s], ind[s, :nnz], b_iptr, W, classes_np)
        if res is not None:
            npa, _, cls = res
        else:
            nseg = nsegB_row[ind[s, :nnz].astype(np.int64)]
            npa = int(nseg.sum())
            segc = np.zeros(nnz + 1, dtype=np.int64)
            np.cumsum(nseg, out=segc[1:])
            exp_pad = W * (segc[iptr[s, 1:]] - segc[iptr[s, :-1]])
            cls = np.searchsorted(classes_np, exp_pad, side="left").astype(np.int32)
            cls[exp_pad == 0] = len(classes) + 1
        if npa * W >= 2**31:
            raise ValueError(
                f"shard {s}: padded expansion exceeds int32 range; "
                "use more shards or chunk rows first"
            )
        npa_max = max(npa_max, npa)
        body.append(npa - _tail_pairs(iptr[s], ind[s], cls, tail, nsegB_row))
        counts_all.append(np.bincount(cls, minlength=len(classes) + 2)[: len(classes) + 1])
        cls_all.append(cls)
    return (
        np.stack(cls_all),
        np.stack(counts_all).astype(np.int64),
        npa_max,
        np.asarray(nnz_s, np.int32),
        np.asarray(body, np.int64),
    )


def _uniform_schedule(classes, counts, slot_budget):
    """Chunk schedule ``[(L, R_pad), ...]`` covering the per-class maximum
    count over shards, per-shard (start, count) tables (nsh, nchunks) int32,
    and each shard's offset of its tail rows in its class order."""
    nsh = counts.shape[0]
    max_counts = counts.max(axis=0)
    offsets = np.concatenate([np.zeros((nsh, 1), np.int64), np.cumsum(counts, axis=1)], axis=1)
    sched, starts, cnts = [], [], []
    for ci, L in enumerate(classes):
        n = int(max_counts[ci])
        rows_per_chunk = max(slot_budget // L, 8)
        for lo in range(0, n, rows_per_chunk):
            cap = min(rows_per_chunk, n - lo)
            R_pad = min(_bucket_pow2(cap), _round_up(cap, 1 << 10))
            sched.append((L, R_pad))
            starts.append(offsets[:, ci] + lo)
            cnts.append(np.clip(counts[:, ci] - lo, 0, rows_per_chunk))
    starts = np.stack(starts, axis=1).astype(np.int32) if sched else np.zeros((nsh, 0), np.int32)
    cnts = np.stack(cnts, axis=1).astype(np.int32) if sched else np.zeros((nsh, 0), np.int32)
    return sched, starts, cnts, offsets[:, len(classes)].astype(np.int64)


def _detect_shard_pattern(S: ShardedCSR, B: CSR) -> bool:
    """All-ones values over host shards (device-held shards are never pulled
    to the host for it: see ``ops.slab_spgemm._is_pattern``)."""
    if not isinstance(S.data, np.ndarray):
        return False
    siptr = np.asarray(S.indptr, np.int64)
    return _is_pattern(B) and all(
        bool(np.all(S.data[s, : int(siptr[s, -1])] == 1)) for s in range(S.n_shards)
    )


class _Shard:
    """One rank's share of a distributed product: the shared sizing and
    schedule, and this rank's shard, ready for ``_piece_exec``."""

    def __init__(self, S: ShardedCSR, B: CSR, mesh: DeviceMesh, axis: str, classes, W: int,
                 slot_budget: int, accum_dtype, pattern):
        n = axis_size(mesh, axis)
        if S.n_shards != n:
            raise ValueError(f"matrix has {S.n_shards} shards, mesh axis {axis} has {n}")
        self.classes = _norm_classes(classes, W)
        self.pattern = _detect_shard_pattern(S, B) if pattern is None else pattern
        self.cls, self.counts, self.npa_max, _, _ = _per_shard_sizing(S, B, W, self.classes)
        ncls = len(self.classes)
        sched, starts, cnts, _ = _uniform_schedule(
            classes=self.classes, counts=self.counts[:, : ncls + 1], slot_budget=slot_budget
        )
        self.tail_per_shard = self.counts[:, ncls]
        self.me = mesh.get_local_rank(axis)
        self.group = mesh.get_group(axis)
        self.dev = mesh_device(mesh)
        self.Bh = B.host()
        self.B_dev = self.Bh.to(self.dev)
        self.sub = local_shard(S, self.me, self.dev)
        self.sc = np.stack([starts, cnts], axis=1)[self.me]  # (2, nchunks)
        self.W = W
        self.kw = _piece_kw(self.Bh, W, self.npa_max, S.rows_per_shard, sched, starts,
                            accum_dtype, self.pattern)

    def exec(self):
        """This shard's (rows_sorted on the device, chunk outputs)."""
        ncls = len(self.classes)
        rows_sorted = _stable_argsort_smallint(self.cls[self.me], ncls + 2).astype(np.int32)
        return _piece_exec(self.sub, torch.from_numpy(rows_sorted).to(self.dev), self.sc,
                           self.B_dev, **self.kw)

    def tails(self, rows_sorted) -> np.ndarray:
        """This shard's tail rows (local ids) in class order."""
        base = int(self.counts[self.me, : len(self.classes)].sum())
        nt = int(self.tail_per_shard[self.me])
        return rows_sorted[base : base + nt].cpu().numpy()


def _all_gather_ragged(t: torch.Tensor, group, n: int) -> list:
    """Every rank's 1-D ``t`` of its own length, in rank order: the sizes
    first, then the payloads padded to the largest (tensor collectives only,
    nothing pickled)."""
    size = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = size.new_empty(n)
    dist.all_gather_into_tensor(sizes, size, group=group)
    sizes = sizes.tolist()
    width = max(max(sizes), 1)
    buf = t.new_zeros(width)
    buf[: t.shape[0]] = t
    out = t.new_empty(n * width)
    dist.all_gather_into_tensor(out, buf, group=group)
    return [out[r * width : r * width + sizes[r]] for r in range(n)]


def _finish_global_csr(C: CSR, sh: "_Shard", S: ShardedCSR) -> CSR:
    """Every rank's local CSR (its rows, B's columns; host- or device-held)
    → the same global host CSR on every rank: the ranks' triples gathered
    through tensor collectives on the mesh's device and stitched there as
    the contiguous row blocks they are (no sort; the rows a shard's padding
    holds past m are cut), then one copy to the host."""
    n, m = S.n_shards, S.shape[0]
    data = _all_gather_ragged(as_tensor(C.data[: C.nnz], sh.dev), sh.group, n)
    inds = _all_gather_ragged(as_tensor(C.indices[: C.nnz], sh.dev).to(torch.int32), sh.group, n)
    iptr = as_tensor(C.indptr, sh.dev).long()
    iptrs = iptr.new_empty(n * iptr.shape[0])
    dist.all_gather_into_tensor(iptrs, iptr, group=sh.group)
    iptrs = iptrs.view(n, -1)
    row_starts = np.asarray(S.row_starts, np.int64)
    parts, off = [iptrs[0, :1]], 0
    for s in range(n):
        own = max(min(S.rows_per_shard, m - int(row_starts[s])), 0)
        parts.append(iptrs[s, 1 : own + 1] + off)
        off += int(data[s].shape[0])
    indptr = torch.cat(parts)
    return CSR(data=torch.cat(data).cpu().numpy(), indices=torch.cat(inds).cpu().numpy(),
               indptr=indptr.cpu().numpy(), shape=(m, C.shape[1]), nnz=int(indptr[-1]))


def spgemm_dist_spmd(
    S: ShardedCSR,
    B: CSR,
    mesh: DeviceMesh,
    *,
    axis: str = "rows",
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=torch.float32,
    as_csr: bool = True,
    pattern: bool | None = None,
):
    """C = A @ B with A row-sharded over ``mesh[axis]``: every rank runs the
    same slab program on its row block, and every rank returns the same
    global host CSR.

    Rows whose padded expansion exceeds the largest class go through the
    rank's global-sort ESC during assembly.  With ``as_csr=False`` this
    rank's raw device outputs are returned as ``(rows_sorted, chunk_outputs,
    tail_rows)``, each with a leading axis of 1 (``tail_rows`` a list of this
    rank's tail row ids): the caller owns the tail rows, whose products are
    NOT in the chunk outputs.  ``pattern=None`` detects all-ones values
    (the reference's forced-1.0 semantics) and drops the value channels."""
    sh = _Shard(S, B, mesh, axis, classes, seg_w, slot_budget, accum_dtype, pattern)
    if not as_csr:
        rows_sorted, outs = sh.exec()
        return (rows_sorted[None], tuple(tuple(x[None] for x in o) for o in outs),
                [sh.tails(rows_sorted)])
    # this rank's rows: compacted on the device, or, with tail rows, pulled
    # and joined with the tail rows' ESC products on the host
    C = _piece_csr(sh.sub, sh.cls[sh.me], sh.counts[sh.me], sh.sc, sh.B_dev, sh.Bh, sh.dev,
                   nclasses=len(sh.classes), nnz_pad=_round_up(sh.npa_max * sh.W, 1024),
                   kw=sh.kw)
    return _finish_global_csr(C, sh, S)


def spgemm_dist_csr(
    S: ShardedCSR,
    B: CSR,
    mesh: DeviceMesh,
    *,
    axis: str = "rows",
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=torch.float32,
    pattern: bool | None = None,
) -> ShardedCSR:
    """C = A @ B with the output kept **row-sharded on each rank's device**:
    every rank compacts its chunk outputs to a local CSR on the device (the
    distributed mirror of ``spgemm_slab_csr``), so C never transits the host
    and chains into further distributed ops.  Returns this rank's block
    (data / indices (1, nnz_pad), indptr (1, rows_pad + 1)); ``nnz`` is the
    sum of the per-shard counts over the axis (one all-reduce of a scalar).

    Requires no heavy-tail rows (their products live outside the slabs);
    raise the class ceiling or use :func:`spgemm_dist_spmd` for host
    assembly with the tail fallback."""
    sh = _Shard(S, B, mesh, axis, classes, seg_w, slot_budget, accum_dtype, pattern)
    if sh.tail_per_shard.sum():
        raise ValueError(
            "device-resident output requires no heavy-tail rows; raise the "
            "class ceiling or use spgemm_dist_spmd (host assembly)"
        )
    _, outs = sh.exec()
    data, indices, indptr, knnz = _compact_to_csr(
        outs, nrow=S.rows_per_shard, nnz_pad=_round_up(sh.npa_max * sh.W, 1024),
        dtype=accum_dtype, device=sh.dev,
    )
    total = knnz.reshape(1).to(torch.int64)
    dist.all_reduce(total, group=sh.group)
    return ShardedCSR(
        data=data[None],
        indices=indices[None],
        indptr=indptr[None],
        row_starts=np.asarray(S.row_starts, np.int32),
        shape=(S.shape[0], B.shape[1]),
        n_shards=S.n_shards,
        rows_per_shard=S.rows_per_shard,
        nnz=int(total),
    )
