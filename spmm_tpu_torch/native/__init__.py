"""Native (C++) host components, loaded via ctypes.

The same C++ as the JAX package (``spmm_tpu/native/*.cpp``, compiled by path
into this package's ``_build/`` by ``native/build.py``): the .mtx coordinate
parser (reference analog: serial_newblock_clock.cpp:47-124) and the
preprocessing passes.  Host-only; no device is involved.  Every function
returns None when the library is unavailable (no sources or no g++) and its
caller then takes the numpy path; a compile that fails raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from spmm_tpu_torch.native.build import build

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    # build() is an mtime-checked no-op when the library is current
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    LL, I32, F64 = ctypes.c_longlong, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double)
    PLL = ctypes.POINTER(ctypes.c_longlong)
    lib.parse_coordinate.restype = LL
    lib.parse_coordinate.argtypes = [ctypes.c_char_p, LL, LL, LL, I32, I32, F64]
    lib.region_split.restype = LL
    lib.region_split.argtypes = [PLL, I32, LL, LL, LL, I32, PLL]
    lib.region_split_permuted.restype = LL
    lib.region_split_permuted.argtypes = [PLL, I32, PLL, LL, LL, LL, I32, PLL]
    lib.relabel_first_touch.restype = LL
    lib.relabel_first_touch.argtypes = [I32, LL, PLL, LL, LL, I32, I32, I32, I32, PLL]
    lib.dominant_sections.restype = None
    lib.dominant_sections.argtypes = [PLL, I32, LL, LL, PLL]
    U8 = ctypes.POINTER(ctypes.c_uint8)
    lib.panel_sort.restype = LL
    lib.panel_sort.argtypes = [PLL, LL, PLL, LL, LL, LL, PLL, U8, PLL, PLL, PLL]
    lib.counting_argsort.restype = None
    lib.counting_argsort.argtypes = [PLL, LL, LL, PLL]
    lib.counting_argsort_i32.restype = None
    lib.counting_argsort_i32.argtypes = [I32, LL, LL, I32]
    lib.pack_blocked.restype = LL
    lib.pack_blocked.argtypes = [
        PLL, I32, ctypes.c_char_p, LL, LL, LL,
        I32, PLL, I32, PLL, LL, I32, I32,
        ctypes.c_char_p, I32, I32, PLL,
    ]
    lib.perm_algebra.restype = None
    lib.perm_algebra.argtypes = [PLL, PLL, PLL, LL, I32, I32, PLL]
    lib.ell_fill_slab.restype = None
    lib.ell_fill_slab.argtypes = [
        ctypes.c_char_p, I32, LL, PLL, PLL, LL, LL,
        ctypes.c_char_p, I32,
    ]
    lib.spgemm_sizing.restype = LL
    lib.spgemm_sizing.argtypes = [PLL, I32, LL, PLL, LL, LL, PLL, LL, I32, PLL]
    _lib = lib
    return _lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


def region_split(indptr: np.ndarray, cols: np.ndarray, ncol: int, budget: int):
    """Native first-touch region splitter; returns region row boundaries
    [0, r1, ..., nrow] or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    nrow = len(indptr) - 1
    stamp = np.empty(max(ncol, 16), dtype=np.int32)  # >= one bitset word
    bounds = np.empty(nrow + 1, dtype=np.int64)
    nb = lib.region_split(_i64p(indptr), _i32p(cols), nrow, ncol, budget, _i32p(stamp), _i64p(bounds))
    return np.concatenate([[0], bounds[:nb]]).astype(np.int64)


def region_split_permuted(
    indptr: np.ndarray, cols: np.ndarray, row_perm: np.ndarray, ncol: int, budget: int
):
    """Native first-touch region splitter over rows visited in ``row_perm``
    order (no materialized reorder).  Returns [0, r1, ..., nrow] or None."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    row_perm = np.ascontiguousarray(row_perm, dtype=np.int64)
    nrow = len(indptr) - 1
    stamp = np.empty(max(ncol, 16), dtype=np.int32)  # >= one bitset word
    bounds = np.empty(nrow + 1, dtype=np.int64)
    nb = lib.region_split_permuted(
        _i64p(indptr), _i32p(cols), _i64p(row_perm), nrow, ncol, budget, _i32p(stamp), _i64p(bounds)
    )
    return np.concatenate([[0], bounds[:nb]]).astype(np.int64)


def relabel_first_touch(cols: np.ndarray, region_nnz: np.ndarray, ncol: int):
    """Native per-region first-touch relabel.  Returns
    (codes, gather_cols, region_counts) or None."""
    lib = _load()
    if lib is None:
        return None
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    region_nnz = np.ascontiguousarray(region_nnz, dtype=np.int64)
    nnz = len(cols)
    nregions = len(region_nnz) - 1
    scratch_map = np.empty(max(ncol, 16), dtype=np.int32)
    scratch_stamp = np.empty(max(ncol, 16), dtype=np.int32)  # >= one bitset word
    codes = np.empty(nnz, dtype=np.int32)
    gather = np.empty(max(nnz, 1), dtype=np.int32)
    counts = np.empty(max(nregions, 1), dtype=np.int64)
    total = lib.relabel_first_touch(
        _i32p(cols), nnz, _i64p(region_nnz), nregions, ncol,
        _i32p(scratch_map), _i32p(scratch_stamp), _i32p(codes), _i32p(gather), _i64p(counts),
    )
    return codes, gather[:total].copy(), counts[:nregions]


def pack_blocked(
    indptr_orig: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    row_perm: np.ndarray,
    indptr_final: np.ndarray,
    row_group: np.ndarray,
    region_bounds: np.ndarray,
    ncol: int,
):
    """Fused gather + v8 interleave + first-touch relabel.  Returns
    (packed_data, cols_local, gather_cols, region_counts) or None."""
    lib = _load()
    if lib is None:
        return None
    indptr_orig = np.ascontiguousarray(indptr_orig, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data)
    row_perm = np.ascontiguousarray(row_perm, dtype=np.int32)
    indptr_final = np.ascontiguousarray(indptr_final, dtype=np.int64)
    row_group = np.ascontiguousarray(row_group, dtype=np.int32)
    region_bounds = np.ascontiguousarray(region_bounds, dtype=np.int64)
    nrow = len(indptr_orig) - 1
    nregions = len(region_bounds) - 1
    nnz = int(indptr_final[-1])
    esz = data.dtype.itemsize
    scratch_map = np.empty(max(ncol, 16), dtype=np.int32)
    scratch_stamp = np.empty(max(ncol, 16), dtype=np.int32)  # >= one bitset word
    packed = np.empty(nnz, dtype=data.dtype)
    cols_local = np.empty(nnz, dtype=np.int32)
    gather = np.empty(max(nnz, 1), dtype=np.int32)
    counts = np.empty(max(nregions, 1), dtype=np.int64)
    total = lib.pack_blocked(
        _i64p(indptr_orig),
        _i32p(indices),
        data.ctypes.data_as(ctypes.c_char_p),
        esz,
        nrow,
        ncol,
        _i32p(row_perm),
        _i64p(indptr_final),
        _i32p(row_group),
        _i64p(region_bounds),
        nregions,
        _i32p(scratch_map),
        _i32p(scratch_stamp),
        packed.ctypes.data_as(ctypes.c_char_p),
        _i32p(cols_local),
        _i32p(gather),
        _i64p(counts),
    )
    if total < 0:  # element size the native kernel doesn't specialize
        return None
    return packed, cols_local, gather[:total].copy(), counts[:nregions]


def ell_fill_slab(
    data: np.ndarray,
    indices: np.ndarray,
    ptr: np.ndarray,
    ln: np.ndarray,
    out_d: np.ndarray,
    out_c: np.ndarray,
) -> bool:
    """Fill one (R, L) ELL slab pair from CSR rows (memcpy/memset per row).
    ``ptr``/``ln`` are int64 source offsets/lengths in slab order; ``out_d``
    (R, L) of data's dtype, ``out_c`` (R, L) int32.  Returns False when the
    native library is unavailable (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return False
    # defensive dtype/layout enforcement: the C side reads int64 offsets and
    # int32 ids — a caller passing int32 offsets would be read as garbage
    # int64 lengths (negative/huge memcpy sizes = heap corruption)
    data = np.ascontiguousarray(data)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    ln = np.ascontiguousarray(ln, dtype=np.int64)
    if not (out_d.flags.c_contiguous and out_c.flags.c_contiguous):
        raise ValueError("ell_fill_slab: outputs must be C-contiguous")
    if out_c.dtype != np.int32 or out_d.dtype != data.dtype:
        raise TypeError("ell_fill_slab: out_c must be int32 and out_d of data's dtype")
    R, L = out_d.shape
    lib.ell_fill_slab(
        data.ctypes.data_as(ctypes.c_char_p),
        _i32p(indices),
        data.dtype.itemsize,
        _i64p(ptr),
        _i64p(ln),
        R,
        L,
        out_d.ctypes.data_as(ctypes.c_char_p),
        _i32p(out_c),
    )
    return True


def perm_algebra(perm1: np.ndarray, perm3: np.ndarray, orig_indptr: np.ndarray):
    """Fused compose/invert/final-indptr (reference wbsort.h:16-67 algebra in
    one native pass).  Returns (row_perm int32, row_inv int32,
    indptr_final int64) or None."""
    lib = _load()
    if lib is None:
        return None
    perm1 = np.ascontiguousarray(perm1, dtype=np.int64)
    perm3 = np.ascontiguousarray(perm3, dtype=np.int64)
    orig_indptr = np.ascontiguousarray(orig_indptr, dtype=np.int64)
    nrow = len(perm1)
    row_perm = np.empty(nrow, dtype=np.int32)
    row_inv = np.empty(nrow, dtype=np.int32)
    indptr_final = np.empty(nrow + 1, dtype=np.int64)
    lib.perm_algebra(
        _i64p(perm1), _i64p(perm3), _i64p(orig_indptr), nrow,
        _i32p(row_perm), _i32p(row_inv), _i64p(indptr_final),
    )
    return row_perm, row_inv, indptr_final


def panel_sort(lens: np.ndarray, panel_bounds: np.ndarray, group_width: int, max_len: int):
    """Native per-panel counting sort by row length + v8 grouping.  Returns
    (perm, is_grouped, group_row, group_len, row_group) or None."""
    lib = _load()
    if lib is None:
        return None
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    panel_bounds = np.ascontiguousarray(panel_bounds, dtype=np.int64)
    nrow = len(lens)
    npanels = len(panel_bounds) - 1
    perm = np.empty(nrow, dtype=np.int64)
    grouped = np.empty(nrow, dtype=np.uint8)
    cap = max(nrow // max(group_width, 1) + 1, 1)
    group_row = np.empty(cap, dtype=np.int64)
    group_len = np.empty(cap, dtype=np.int64)
    row_group = np.empty(nrow, dtype=np.int64)
    ng = lib.panel_sort(
        _i64p(lens), nrow, _i64p(panel_bounds), npanels,
        group_width, max_len, _i64p(perm),
        grouped.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _i64p(group_row), _i64p(group_len), _i64p(row_group),
    )
    return perm, grouped.astype(bool), group_row[:ng].copy(), group_len[:ng].copy(), row_group


def spgemm_sizing(a_indptr, a_ind, b_indptr, seg_w: int, classes):
    """Native one-pass slab SpGEMM sizing (``ops/slab_spgemm.py``): for
    C = A @ B with B rows cut into ``seg_w``-wide segments, returns (npa,
    nsegB, cls) — the (A-nonzero × B-segment) pair count, the B segment
    count and each A row's expansion class (index into the ascending
    ``classes``; ``len(classes)`` above the last, ``len(classes) + 1`` for
    an empty expansion) — or None."""
    lib = _load()
    if lib is None:
        return None
    a_indptr = np.ascontiguousarray(a_indptr, dtype=np.int64)
    a_ind = np.ascontiguousarray(a_ind, dtype=np.int32)
    b_indptr = np.ascontiguousarray(b_indptr, dtype=np.int64)
    classes = np.ascontiguousarray(classes, dtype=np.int64)
    nrowA = len(a_indptr) - 1
    nrowB = len(b_indptr) - 1
    # the C pass reads b_indptr[a_ind[p]] unchecked
    if len(a_ind) < a_indptr[-1]:
        raise ValueError("spgemm_sizing: a_ind is shorter than a_indptr[-1]")
    if len(a_ind) and (int(a_ind.min()) < 0 or int(a_ind.max()) >= nrowB):
        raise ValueError("spgemm_sizing: a column index of A is not a row of B")
    cls = np.empty(nrowA, dtype=np.int32)
    nsegB = np.zeros(1, dtype=np.int64)
    npa = lib.spgemm_sizing(
        _i64p(a_indptr), _i32p(a_ind), nrowA, _i64p(b_indptr), nrowB,
        seg_w, _i64p(classes), len(classes), _i32p(cls), _i64p(nsegB),
    )
    return int(npa), int(nsegB[0]), cls


def counting_argsort_i32(keys: np.ndarray, nkeys: int):
    """Native stable counting argsort of int32 keys in [0, nkeys) with int32
    output (no widening copies) or None."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    perm = np.empty(len(keys), dtype=np.int32)
    lib.counting_argsort_i32(_i32p(keys), len(keys), nkeys, _i32p(perm))
    return perm


def counting_argsort(keys: np.ndarray, nkeys: int):
    """Native stable counting argsort of int keys in [0, nkeys).  Returns
    perm (perm[new_pos] = old_pos) or None."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    perm = np.empty(len(keys), dtype=np.int64)
    lib.counting_argsort(_i64p(keys), len(keys), nkeys, _i64p(perm))
    return perm


def dominant_sections(indptr: np.ndarray, cols: np.ndarray, section_size: int):
    """Native per-row dominant section (CSR with sorted columns) or None."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    nrow = len(indptr) - 1
    dom = np.empty(nrow, dtype=np.int64)
    lib.dominant_sections(_i64p(indptr), _i32p(cols), nrow, section_size, _i64p(dom))
    return dom


def available() -> bool:
    return _load() is not None


def parse_coordinate_body(body: bytes, num_fields: int, num_lines: int) -> Optional[np.ndarray]:
    """Parse ``num_lines`` whitespace-separated coordinate entries from
    ``body``.  Returns an (n, num_fields) float64 table (cols 0/1 are 1-based
    indices), or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    rows = np.empty(num_lines, dtype=np.int32)
    cols = np.empty(num_lines, dtype=np.int32)
    vals = np.empty(num_lines, dtype=np.float64)
    n = lib.parse_coordinate(
        body,
        len(body),
        num_lines,
        num_fields,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if n != num_lines:
        raise ValueError(f".mtx truncated: expected {num_lines} entries, parsed {n}")
    out = np.empty((num_lines, num_fields), dtype=np.float64)
    out[:, 0] = rows
    out[:, 1] = cols
    if num_fields >= 3:
        out[:, 2] = vals
    if num_fields >= 4:
        out[:, 3] = 0.0
    return out
