"""Uniform-schedule sizing for row-partitioned SpGEMM (port of the two host
helpers of ``spmm_tpu/parallel/spgemm_spmd.py``).

Every piece (or shard) of a row-partitioned A runs the same slab program
(``ops/slab_spgemm.py``) with one chunk schedule: the pa padding is the
maximum over pieces, the schedule is built from the per-class maximum row
counts, and each piece gets its own (start, count) per chunk (an empty chunk
only masks).  The streamed big path (``spgemm_slab_big``) uses them.
"""

from __future__ import annotations

import numpy as np

from spmm_tpu_torch import native
from spmm_tpu_torch.formats.containers import CSR
from spmm_tpu_torch.ops.slab_spgemm import _bucket_pow2, _round_up, _tail_pairs
from spmm_tpu_torch.parallel.partition import ShardedCSR


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
