"""Sparse matrix transforms — transpose, add, diagonal, reductions (port of
``spmm_tpu/ops/transform.py``).

The standard algebra around the multiply kernels: Aᵀ for graph reversal,
A + B for graph unions, diagonals and row/column sums for normalisation (the
random-walk matrix D⁻¹A of PageRank-style chained SpMV).  All host numpy,
O(nnz) counting passes; containers holding tensors are brought to the host
first.
"""

from __future__ import annotations

import numpy as np

from spmm_tpu_torch import native
from spmm_tpu_torch.formats.containers import COO, CSR, to_csr


def transpose(A: CSR) -> CSR:
    """Aᵀ as canonical CSR: a stable counting sort by column, so within a
    column the rows keep their (ascending) CSR order."""
    h = A.host()
    m, n = A.shape
    nnz = A.nnz
    cols = np.asarray(h.indices[:nnz], dtype=np.int64)
    indptr = np.asarray(h.indptr, dtype=np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), indptr[1:] - indptr[:-1])
    cnt = np.bincount(cols, minlength=n)
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cnt, out=out_indptr[1:])
    order = _stable_argsort_smallint(cols, n)
    out_ind = rows[order].astype(np.int32)
    out_dat = np.asarray(h.data[:nnz])[order]
    return CSR(data=out_dat, indices=out_ind, indptr=out_indptr, shape=(n, m), nnz=nnz)


def _stable_argsort_smallint(keys: np.ndarray, nkeys: int) -> np.ndarray:
    """Stable argsort of integer keys in [0, nkeys): the native O(n + nkeys)
    counting sort, or numpy's stable argsort without the native library."""
    perm = native.counting_argsort(keys, nkeys)
    return perm if perm is not None else np.argsort(keys, kind="stable")


def add(A: CSR, B: CSR, alpha: float = 1.0, beta: float = 1.0) -> CSR:
    """alpha*A + beta*B as canonical CSR (duplicate coordinates merged;
    exact zeros are kept — pattern-stable like scipy's)."""
    if A.shape != B.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {B.shape}")
    Ah, Bh = A.host(), B.host()
    m, n = A.shape
    ra = np.repeat(np.arange(m, dtype=np.int64), np.diff(np.asarray(Ah.indptr, dtype=np.int64)))
    rb = np.repeat(np.arange(m, dtype=np.int64), np.diff(np.asarray(Bh.indptr, dtype=np.int64)))
    rows = np.concatenate([ra, rb])
    cols = np.concatenate(
        [np.asarray(Ah.indices[: A.nnz], np.int64), np.asarray(Bh.indices[: B.nnz], np.int64)]
    )
    vals = np.concatenate(
        [alpha * np.asarray(Ah.data[: A.nnz]), beta * np.asarray(Bh.data[: B.nnz])]
    )
    key = rows * np.int64(n) + cols
    if len(key) == 0:
        out = COO(
            row=np.zeros(0, np.int32), col=np.zeros(0, np.int32),
            data=np.zeros(0, vals.dtype), shape=(m, n), nnz=0,
        )
        return to_csr(out, sort_within_row=False, sum_duplicates=False)
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    first = np.concatenate([[True], key[1:] != key[:-1]])
    seg = np.cumsum(first) - 1
    out_vals = np.zeros(int(seg[-1]) + 1, dtype=vals.dtype)
    np.add.at(out_vals, seg, vals)
    ukey = key[first]
    out = COO(
        row=(ukey // n).astype(np.int32),
        col=(ukey % n).astype(np.int32),
        data=out_vals,
        shape=(m, n),
        nnz=len(ukey),
    )
    return to_csr(out, sort_within_row=False, sum_duplicates=False)


def diagonal(A: CSR) -> np.ndarray:
    """Main diagonal as a dense vector."""
    h = A.host()
    m, n = A.shape
    indptr = np.asarray(h.indptr, dtype=np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), indptr[1:] - indptr[:-1])
    cols = np.asarray(h.indices[: A.nnz], dtype=np.int64)
    vals = np.asarray(h.data[: A.nnz])
    d = np.zeros(min(m, n), dtype=vals.dtype)
    on = rows == cols
    np.add.at(d, rows[on], vals[on])
    return d


def row_sums(A: CSR) -> np.ndarray:
    h = A.host()
    indptr = np.asarray(h.indptr, dtype=np.int64)
    vals = np.asarray(h.data[: A.nnz])
    cs = np.zeros(A.nnz + 1, dtype=np.float64)
    np.cumsum(vals, out=cs[1:])
    return (cs[indptr[1:]] - cs[indptr[:-1]]).astype(vals.dtype)


def col_sums(A: CSR) -> np.ndarray:
    h = A.host()
    vals = np.asarray(h.data[: A.nnz])
    cols = np.asarray(h.indices[: A.nnz], dtype=np.int64)
    out = np.zeros(A.shape[1], dtype=np.float64)
    np.add.at(out, cols, vals)
    return out.astype(vals.dtype)


def scale_rows(A: CSR, s: np.ndarray) -> CSR:
    """diag(s) @ A (e.g. D⁻¹A for random-walk normalisation)."""
    h = A.host()
    indptr = np.asarray(h.indptr, dtype=np.int64)
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64), indptr[1:] - indptr[:-1])
    data = np.asarray(h.data[: A.nnz]) * np.asarray(s)[rows]
    return CSR(
        data=data,
        indices=np.asarray(h.indices[: A.nnz], np.int32),
        indptr=indptr,
        shape=A.shape,
        nnz=A.nnz,
    )


def scale_cols(A: CSR, s: np.ndarray) -> CSR:
    """A @ diag(s)."""
    h = A.host()
    cols = np.asarray(h.indices[: A.nnz], dtype=np.int64)
    data = np.asarray(h.data[: A.nnz]) * np.asarray(s)[cols]
    return CSR(
        data=data,
        indices=cols.astype(np.int32),
        indptr=np.asarray(h.indptr, dtype=np.int64),
        shape=A.shape,
        nnz=A.nnz,
    )
