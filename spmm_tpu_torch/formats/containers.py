"""Sparse containers: frozen dataclasses over numpy arrays or torch tensors.

PyTorch counterpart of ``spmm_tpu/formats/containers.py`` (the reference's
``SpM`` CSR class, PreProcessing/csr.h:8-117).  Field names, field order and
the padding rules are the JAX package's: entries past ``nnz`` (up to the
array length ``nnz_pad``) hold data 0 and index 0, so they are no-ops in every
gather/scatter.  Leaves are numpy arrays on the host (ingest and
preprocessing) or torch tensors on a device (kernels); ``to(device)`` moves
every leaf, ``host()`` brings every leaf back as numpy.

The dataclasses are frozen but not slotted, so they stay weak-referenceable
(the SpMM dispatcher memoizes ELL packs by a weak reference to the CSR).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

Array = Any  # np.ndarray | torch.Tensor


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def as_tensor(a, device) -> torch.Tensor:
    """numpy array or tensor → tensor on ``device`` (no copy when it is
    already there)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, copy=True, order="C")
    return torch.from_numpy(a).to(device)


def as_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def is_array(a) -> bool:
    return isinstance(a, (np.ndarray, torch.Tensor))


def map_arrays(obj, fn):
    """Apply ``fn`` to every array leaf of a container (recursing into
    tuples of arrays and nested containers); static fields pass through."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        kw = {f.name: map_arrays(getattr(obj, f.name), fn) for f in dataclasses.fields(obj)}
        return type(obj)(**kw)
    if isinstance(obj, tuple) and obj and all(is_array(a) for a in obj):
        return tuple(fn(a) for a in obj)
    if is_array(obj):
        return fn(obj)
    return obj


class Container:
    """``to(device)`` / ``host()`` for every container."""

    def to(self, device):
        return map_arrays(self, lambda a: as_tensor(a, device))

    def host(self):
        return map_arrays(self, as_numpy)


def _cat_zeros(a, grow: int):
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_zeros((grow,))])
    return np.concatenate([a, np.zeros((grow,), a.dtype)])


@dataclasses.dataclass(frozen=True)
class COO(Container):
    """Coordinate-format sparse matrix; entries beyond ``nnz`` have
    ``data == 0`` and ``row == col == 0``."""

    row: Array  # (nnz_pad,) int32
    col: Array  # (nnz_pad,) int32
    data: Array  # (nnz_pad,) float
    shape: Tuple[int, int]
    nnz: int

    @property
    def nnz_pad(self) -> int:
        return int(self.row.shape[0])

    def pad(self, multiple: int = 8) -> "COO":
        tgt = _round_up(max(self.nnz, 1), multiple)
        if tgt == self.nnz_pad:
            return self
        grow = tgt - self.nnz_pad
        if grow < 0:  # shrink back to tight padding
            return COO(self.row[:tgt], self.col[:tgt], self.data[:tgt], self.shape, self.nnz)
        z = lambda a: _cat_zeros(a, grow)
        return COO(z(self.row), z(self.col), z(self.data), self.shape, self.nnz)


@dataclasses.dataclass(frozen=True)
class CSR(Container):
    """Compressed-sparse-row matrix: ``indptr`` has length ``shape[0] + 1``
    with ``indptr[-1] == nnz``; ``data``/``indices`` in ``[nnz, nnz_pad)``
    are zero padding."""

    data: Array  # (nnz_pad,) float
    indices: Array  # (nnz_pad,) int32
    indptr: Array  # (nrow + 1,) int32
    shape: Tuple[int, int]
    nnz: int

    @property
    def nnz_pad(self) -> int:
        return int(self.data.shape[0])

    @property
    def nrow(self) -> int:
        return self.shape[0]

    @property
    def ncol(self) -> int:
        return self.shape[1]

    def pad(self, multiple: int = 8) -> "CSR":
        tgt = _round_up(max(self.nnz, 1), multiple)
        if tgt == self.nnz_pad:
            return self
        if tgt < self.nnz_pad:
            return CSR(self.data[:tgt], self.indices[:tgt], self.indptr, self.shape, self.nnz)
        grow = tgt - self.nnz_pad
        z = lambda a: _cat_zeros(a, grow)
        return CSR(z(self.data), z(self.indices), self.indptr, self.shape, self.nnz)

    def row_ids(self) -> Array:
        """Per-nonzero row id (the padded tail maps to the last row; padded
        data is zero so downstream scatters are no-ops)."""
        if isinstance(self.data, np.ndarray):
            pos = np.arange(self.nnz_pad, dtype=np.int64)
            r = np.searchsorted(self.indptr, pos, side="right").astype(np.int32) - 1
            return np.clip(r, 0, self.shape[0] - 1)
        from spmm_tpu_torch.ops.segments import boundary_segments

        return boundary_segments(self.indptr, self.nnz_pad)

    def row_lengths(self) -> Array:
        return self.indptr[1:] - self.indptr[:-1]

    # --- interop ------------------------------------------------------------
    def to_scipy(self):
        import scipy.sparse as sp

        h = self.host()
        return sp.csr_matrix(
            (np.asarray(h.data[: h.nnz]), np.asarray(h.indices[: h.nnz]), np.asarray(h.indptr)),
            shape=self.shape,
        )

    @staticmethod
    def from_scipy(m, dtype=None) -> "CSR":
        """Value dtype is preserved unless ``dtype`` is given."""
        m = m.tocsr()
        return CSR(
            data=np.asarray(m.data, dtype=dtype if dtype is not None else m.data.dtype),
            indices=np.asarray(m.indices, dtype=np.int32),
            indptr=np.asarray(m.indptr, dtype=np.int32),
            shape=(int(m.shape[0]), int(m.shape[1])),
            nnz=int(m.nnz),
        )


@dataclasses.dataclass(frozen=True)
class BlockedCSR(Container):
    """The preprocessed, blocked format — output of the full pipeline (the
    reference's per-region ``bserial_*`` buffers plus the permutation vectors
    ``seq / rseq / seq_input / seq_offset``, serial_newblock_clock.cpp:336-453,
    wbsort.h:16-95).  Rows are in final (bitmap ∘ panel-sort) order; v8 groups
    are stored 8-row interleaved (slot ``base + 8*e + r`` holds element ``e``
    of group-row ``r``); column ids are relabeled per region in first-touch
    order of the packed stream."""

    # packed nonzeros (region-concatenated, v8 groups interleaved)
    data: Array  # (nnz_pad,) float
    cols_local: Array  # (nnz_pad,) int32 — region-relabeled column ids
    indptr: Array  # (nrow + 1,) int32 — CSR indptr over rows in final order
    # permutations
    row_perm: Array  # (nrow,) int32: original row id at each final position ("seq")
    row_inv: Array  # (nrow,) int32: final position of each original row ("rseq")
    # regions
    region_rows: Array  # (nregions + 1,) int32 row boundaries in final order
    region_nnz: Array  # (nregions + 1,) int32 packed-nnz boundaries
    # per-region compacted RHS gather lists
    gather_cols: Array  # (ndistinct,) int32 original column id per relabeled slot
    region_gather: Array  # (nregions + 1,) int32 offsets into gather_cols ("seq_offset")
    gather_rows: Array  # (ndistinct,) int32 final row position per slot ("seq_input"; square only)
    # v8 group table: one row per 8-row group
    group_row: Array  # (ngroups,) int32 final row index of the group's first row
    group_len: Array  # (ngroups,) int32 per-row length L of the group
    group_nnz: Array  # (ngroups,) int32 offset of the group's packed 8*L block
    group_region: Array  # (ngroups,) int32 owning region
    row_group: Array  # (nrow,) int32 — group id of each final row, or -1
    shape: Tuple[int, int]
    nnz: int
    nregions: int
    ngroups: int
    ndistinct: int

    @property
    def nrow(self) -> int:
        return self.shape[0]


# ------------------------------------------------------------------------------
# conversions (host-side numpy)
# ------------------------------------------------------------------------------


def to_csr(m: COO, *, sort_within_row: bool = True, sum_duplicates: bool = False) -> CSR:
    """COO → CSR by stable sort on row ids.

    The reference keeps file order within a row and never dedups
    (serial_newblock_clock.cpp:105-112); pass ``sort_within_row=False,
    sum_duplicates=False`` for exact parity.
    """
    h = m.host()
    row = np.asarray(h.row[: h.nnz], dtype=np.int64)
    col = np.asarray(h.col[: h.nnz], dtype=np.int64)
    dat = np.asarray(h.data[: h.nnz])
    nrow, ncol = m.shape
    if sort_within_row:
        order = np.lexsort((col, row))
    else:
        order = np.argsort(row, kind="stable")
    row, col, dat = row[order], col[order], dat[order]
    if sum_duplicates and len(row):
        key_new = np.empty(len(row), dtype=bool)
        key_new[0] = True
        key_new[1:] = (row[1:] != row[:-1]) | (col[1:] != col[:-1])
        idx = np.cumsum(key_new) - 1
        out_dat = np.zeros(int(idx[-1]) + 1, dtype=dat.dtype)
        np.add.at(out_dat, idx, dat)
        row, col, dat = row[key_new], col[key_new], out_dat
    indptr = np.zeros(nrow + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(
        data=dat,
        indices=col.astype(np.int32),
        indptr=indptr.astype(np.int32),
        shape=(nrow, ncol),
        nnz=int(len(row)),
    )


def to_coo(m: CSR) -> COO:
    h = m.host()
    row = np.asarray(h.row_ids()[: h.nnz], dtype=np.int32)
    return COO(
        row=row,
        col=np.asarray(h.indices[: h.nnz], dtype=np.int32),
        data=np.asarray(h.data[: h.nnz]),
        shape=m.shape,
        nnz=m.nnz,
    )


def permute_rows(m: CSR, perm: np.ndarray) -> CSR:
    """Materialize a row permutation: row ``i`` of the result is row
    ``perm[i]`` of ``m`` (the reference's ``reorder_row``, transmat.h:11-169)."""
    h = m.host()
    lens = np.asarray(h.row_lengths(), dtype=np.int64)[perm]
    indptr = np.zeros(m.nrow + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    starts = np.asarray(h.indptr, dtype=np.int64)[perm]
    pos = np.arange(m.nnz, dtype=np.int64)
    row_out = np.repeat(np.arange(m.nrow, dtype=np.int64), lens)
    src = starts[row_out] + (pos - indptr[row_out])
    return CSR(
        data=np.asarray(h.data)[src],
        indices=np.asarray(h.indices)[src],
        indptr=indptr.astype(np.int32),
        shape=m.shape,
        nnz=m.nnz,
    )
