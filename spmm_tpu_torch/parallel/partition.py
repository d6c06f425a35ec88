"""Row partitioning of sparse matrices (port of the host part of
``spmm_tpu/parallel/partition.py``).

The reference's region split (SURVEY.md §2.4) is the unit to cut a matrix
by: row blocks, padded to uniform shapes (rows, nnz) and stacked along a
leading shard axis.  The streamed big SpGEMM runs one such block per piece.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np

from spmm_tpu_torch.formats.containers import CSR, Container

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


def partition_rows(A: CSR, n_shards: int, *, nnz_align: int = 128) -> ShardedCSR:
    """Split A into ``n_shards`` equal row blocks (row-balanced; for
    nnz-balanced splits preprocess first — the bitmap reorder clusters heavy
    rows so equal-nnz splits follow from region boundaries)."""
    h = A.host()
    m, n = A.shape
    rows_per = _round_up((m + n_shards - 1) // n_shards, 8)
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
