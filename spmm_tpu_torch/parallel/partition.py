"""Row and column partitioning of sparse matrices (port of
``spmm_tpu/parallel/partition.py``).

The reference's region split (SURVEY.md §2.4) is the unit to cut a matrix
by: row blocks, padded to uniform shapes (rows, nnz) and stacked along a
leading shard axis.  The streamed big SpGEMM runs one such block per piece;
the distributed products give rank r shard r (:func:`local_shard`), the
counterpart of the JAX package's ``.device(sharding)`` placement.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from spmm_tpu_torch.formats.containers import CSR, Container, as_numpy, as_tensor, memo_of

Array = Any


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ShardedCSR(Container):
    """``n_shards`` row blocks of a CSR matrix, padded to uniform shapes.

    ``data``/``indices``: (n_shards, nnz_pad); ``indptr``: (n_shards,
    rows_pad + 1); padded rows are empty, padded nonzeros are zeros.
    ``row_starts`` gives each shard's global first row."""

    data: Array
    indices: Array
    indptr: Array
    row_starts: Array  # (n_shards,) int32 global row offset per shard
    shape: Tuple[int, int]
    n_shards: int
    rows_per_shard: int
    nnz: int


def rows_per_shard(m: int, n_shards: int) -> int:
    """The height of :func:`partition_rows`' blocks of an m-row matrix."""
    return _round_up((m + n_shards - 1) // n_shards, 8)


def partition_rows(A: CSR, n_shards: int, *, nnz_align: int = 128) -> ShardedCSR:
    """Split A into ``n_shards`` equal row blocks (row-balanced; for
    nnz-balanced splits preprocess first — the bitmap reorder clusters heavy
    rows so equal-nnz splits follow from region boundaries)."""
    h = A.host()
    m, n = A.shape
    rows_per = rows_per_shard(m, n_shards)
    indptr = np.asarray(h.indptr, dtype=np.int64)
    starts = np.minimum(np.arange(n_shards, dtype=np.int64) * rows_per, m)
    ends = np.minimum(starts + rows_per, m)
    max_nnz = int(max(indptr[e] - indptr[s] for s, e in zip(starts, ends)))
    nnz_pad = _round_up(max_nnz, nnz_align)

    data = np.zeros((n_shards, nnz_pad), dtype=np.asarray(h.data).dtype)
    indices = np.zeros((n_shards, nnz_pad), dtype=np.int32)
    sh_indptr = np.zeros((n_shards, rows_per + 1), dtype=np.int32)
    for i, (s, e) in enumerate(zip(starts, ends)):
        lo, hi = int(indptr[s]), int(indptr[e])
        data[i, : hi - lo] = np.asarray(h.data[lo:hi])
        indices[i, : hi - lo] = np.asarray(h.indices[lo:hi], dtype=np.int32)
        local = (indptr[s : e + 1] - lo).astype(np.int32)
        sh_indptr[i, : e - s + 1] = local
        sh_indptr[i, e - s + 1 :] = local[-1] if len(local) else 0
    return ShardedCSR(
        data=data,
        indices=indices,
        indptr=sh_indptr,
        row_starts=starts.astype(np.int32),
        shape=(m, n),
        n_shards=n_shards,
        rows_per_shard=rows_per,
        nnz=A.nnz,
    )


@dataclasses.dataclass(frozen=True)
class ColShardedCSR(Container):
    """``n_shards`` COLUMN blocks of a CSR matrix (contraction-dimension split).

    Each shard holds the sub-CSR of its column range over ALL rows, with
    column ids relocalised to the block (``indices - col_start``); rows are
    padded to ``rows_pad`` (a multiple of ``8 * n_shards`` so a reduce-scatter
    over the row dimension tiles evenly).  The mirror of :class:`ShardedCSR`:
    shard the K axis, not the M axis."""

    data: Array  # (n_shards, nnz_pad)
    indices: Array  # (n_shards, nnz_pad) block-local column ids
    indptr: Array  # (n_shards, rows_pad + 1)
    col_starts: Array  # (n_shards,) int32 global first column per shard
    shape: Tuple[int, int]
    n_shards: int
    cols_per_shard: int
    rows_pad: int
    nnz: int


def partition_cols(A: CSR, n_shards: int, *, nnz_align: int = 128) -> ColShardedCSR:
    """Split A into ``n_shards`` equal COLUMN blocks (the contraction axis).

    Within a row, each shard keeps its nonzeros in original order (the
    reference's no-sort CSR contract, SURVEY.md §2.1)."""
    h = A.host()
    m, n = A.shape
    cols_per = _round_up((n + n_shards - 1) // n_shards, 8)
    rows_pad = _round_up(m, 8 * n_shards)
    indptr = np.asarray(h.indptr, dtype=np.int64)[: m + 1]
    cols = np.asarray(h.indices, dtype=np.int64)[: A.nnz]
    vals = np.asarray(h.data)[: A.nnz]
    rows_nnz = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))

    shard_of = np.minimum(cols // cols_per, n_shards - 1)
    counts = np.bincount(shard_of, minlength=n_shards)
    nnz_pad = _round_up(int(counts.max()) if len(counts) else 1, nnz_align)

    # one stable grouping pass instead of a mask per shard: nonzeros are
    # row-major, so a stable sort by shard id leaves each shard's nonzeros
    # contiguous and still in row-major order
    order = np.argsort(shard_of, kind="stable")
    bounds = np.zeros(n_shards + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])

    data = np.zeros((n_shards, nnz_pad), dtype=vals.dtype)
    indices = np.zeros((n_shards, nnz_pad), dtype=np.int32)
    sh_indptr = np.zeros((n_shards, rows_pad + 1), dtype=np.int32)
    starts = (np.arange(n_shards, dtype=np.int64) * cols_per).astype(np.int32)
    for i in range(n_shards):
        sel = order[bounds[i] : bounds[i + 1]]
        k = len(sel)
        data[i, :k] = vals[sel]
        indices[i, :k] = (cols[sel] - starts[i]).astype(np.int32)
        rc = np.bincount(rows_nnz[sel], minlength=rows_pad).astype(np.int64)
        np.cumsum(rc, out=rc)
        sh_indptr[i, 1:] = rc.astype(np.int32)
    return ColShardedCSR(
        data=data,
        indices=indices,
        indptr=sh_indptr,
        col_starts=starts,
        shape=(m, n),
        n_shards=n_shards,
        cols_per_shard=cols_per,
        rows_pad=rows_pad,
        nnz=A.nnz,
    )


def local_shard(S, index: int, device) -> CSR:
    """Shard ``index`` of a :class:`ShardedCSR` or :class:`ColShardedCSR` as a
    tight local CSR on ``device`` (rows_pad rows; a column shard's columns
    are block-local).  Memoized on ``S`` per (shard, device), so repeated
    products reuse the shard's ELL pack and K2's work table, which are kept
    per CSR instance."""
    dev = torch.device(device)
    memo = memo_of(S, "_local_shards")
    key = (int(index), str(dev))
    if memo is not None and key in memo:
        return memo[key]
    iptr = as_numpy(S.indptr[index]).astype(np.int64)
    nnz = int(iptr[-1])
    ncol = S.cols_per_shard if isinstance(S, ColShardedCSR) else S.shape[1]
    C = CSR(
        data=as_tensor(S.data[index][:nnz], dev),
        indices=as_tensor(S.indices[index][:nnz], dev).to(torch.int32),
        indptr=as_tensor(iptr, dev),
        shape=(len(iptr) - 1, ncol),
        nnz=nnz,
    )
    if memo is not None:
        memo[key] = C
    return C


def unshard_rows(Y_sharded, S: ShardedCSR) -> np.ndarray:
    """(n_shards, rows_pad, k) → (m, k): drop per-shard row padding.  Takes
    the ranks' blocks stacked along the leading axis."""
    m = S.shape[0]
    out = np.concatenate([as_numpy(Y_sharded[i]) for i in range(S.n_shards)], axis=0)
    return out[:m]


def unshard_csr_rows(S: ShardedCSR) -> CSR:
    """Reassemble a row-sharded CSR (e.g. the ranks' blocks of
    ``spgemm_dist_csr``'s output, stacked) into one global host CSR.  Shards
    are contiguous row blocks, so the merge is a concatenation of trimmed
    local triples with indptr offsets, no sort; only each shard's real
    nonzeros (``data[s, :nnz_s]``) are pulled, never the padded tails."""
    iptr = as_numpy(S.indptr).astype(np.int64)
    m = S.shape[0]
    datas, inds, iptrs = [], [], []
    off = 0
    row_starts = as_numpy(S.row_starts).astype(np.int64)
    for s in range(S.n_shards):
        k = int(iptr[s, -1])
        datas.append(as_numpy(S.data[s][:k]))
        inds.append(as_numpy(S.indices[s][:k]).astype(np.int32))
        # rows this shard owns (the last shard's padding overhangs m)
        own = max(min(S.rows_per_shard, m - int(row_starts[s])), 0)
        ip = iptr[s, : own + 1] + off
        iptrs.append(ip if s == 0 else ip[1:])
        off = int(ip[-1]) if len(ip) else off
    indptr = np.concatenate(iptrs) if iptrs else np.zeros(1, np.int64)
    data = np.concatenate(datas) if datas else np.zeros(0, np.float32)
    return CSR(
        data=data,
        indices=np.concatenate(inds) if inds else np.zeros(0, np.int32),
        indptr=indptr,
        shape=S.shape,
        nnz=int(indptr[-1]),
    )
