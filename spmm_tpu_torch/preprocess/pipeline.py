"""Passes 3c/4 + end-to-end pipeline: pack, relabel, permutation algebra
(port of ``spmm_tpu/preprocess/pipeline.py``; host numpy + the shared native
passes, so both packages produce the same ``BlockedCSR`` field for field).

Redesign of the reference's per-region materialization loop and
permutation algebra (reference: serial_newblock_clock.cpp:310-453 row gather +
v8 interleave pack + column relabel; wbsort.h:16-95 compose/invert/seq_input;
SURVEY.md §2.7-2.8).  The reference computes these buffers then leaks them
(its driver bugs, SURVEY.md §2.7); here they are the actual product: a
``BlockedCSR`` ready for the blocked kernels, serializable to disk.

Packing layout (identical contract to the reference's intended output):
- rows appear in final order  (bitmap reorder ∘ panel sort);
- each v8 group's 8 equal-length rows are stored 8-row interleaved:
  packed slot ``base + 8*e + r`` holds element ``e`` of group-row ``r``
  (the fp32 sublane layout, serial_newblock_clock.cpp:366-385);
- non-grouped ("remain") rows keep plain CSR order;
- column ids are relabeled 0,1,2,... per region in first-touch order of the
  packed stream (serial_newblock_clock.cpp:187-204), with ``gather_cols``
  recording relabel→original and ``gather_rows = row_inv[gather_cols]`` the
  self-referential A×A gather map (square matrices only, wbsort.h:81-95).
"""

from __future__ import annotations

import numpy as np

from spmm_tpu_torch import native
from spmm_tpu_torch.config import Config, default_config
from spmm_tpu_torch.formats.containers import COO, CSR, BlockedCSR, permute_rows, to_csr
from spmm_tpu_torch.preprocess.panels import PanelSortResult, panel_sort, panelize
from spmm_tpu_torch.preprocess.regions import split_regions
from spmm_tpu_torch.preprocess.reorder import bitmap_reorder


def _relabel(packed_cols, region_nnz, nregions, ncol):
    """Per-region first-touch relabel of the packed stream → (cols_local,
    gather_cols, region_gather).  Native O(nnz) scan when available; numpy
    sort-based fallback otherwise."""
    res = native.relabel_first_touch(packed_cols, region_nnz, ncol)
    if res is not None:
        codes, gather_cols, region_counts = res
        region_gather = np.zeros(nregions + 1, dtype=np.int64)
        np.cumsum(region_counts, out=region_gather[1:])
        return codes.astype(np.int64), gather_cols.astype(np.int64), region_gather

    pos = np.arange(len(packed_cols), dtype=np.int64)
    region_of_pos = np.searchsorted(region_nnz, pos, side="right") - 1
    key = region_of_pos * np.int64(ncol) + packed_cols
    uniq, first_pos, inv = np.unique(key, return_index=True, return_inverse=True)
    # np.unique's first_pos is the first occurrence in the packed order
    # (stable mergesort); order the uniques by (region, first touch position).
    ureg = (uniq // np.int64(ncol)).astype(np.int64)
    order = np.lexsort((first_pos, ureg))
    rank_of_uniq = np.empty(len(uniq), dtype=np.int64)
    region_counts = np.bincount(ureg, minlength=nregions)
    region_gather = np.zeros(nregions + 1, dtype=np.int64)
    np.cumsum(region_counts, out=region_gather[1:])
    rank_of_uniq[order] = np.arange(len(uniq), dtype=np.int64) - region_gather[ureg[order]]
    cols_local = rank_of_uniq[inv]
    gather_cols = (uniq % np.int64(ncol))[order]
    return cols_local, gather_cols, region_gather


def preprocess(A: CSR, config: Config | None = None) -> BlockedCSR:
    cfg = config or default_config()
    h = A.host()
    nrow, ncol = A.shape

    # --- pass 1: dominant-section row reorder --------------------------------
    _, perm1 = bitmap_reorder(h, cfg.section_size, materialize=False)
    orig_lens = np.asarray(h.row_lengths(), dtype=np.int64)
    lens1 = orig_lens[perm1]

    # --- pass 2: VMEM-budget region split (over the permuted row order) -------
    region_bounds = native.region_split_permuted(
        np.asarray(h.indptr, dtype=np.int64),
        np.asarray(h.indices[: A.nnz]),
        perm1,
        ncol,
        cfg.region_budget,
    )
    if region_bounds is None:
        region_bounds = split_regions(permute_rows(h, perm1), cfg.region_budget)

    # --- pass 3a/3b: panelize + per-panel length sort + v8 grouping -----------
    panel_bounds = panelize(lens1, region_bounds, cfg.panel_rows, cfg.group_width)
    row_group_native = None
    res3 = native.panel_sort(lens1, panel_bounds, cfg.group_width, cfg.max_group_row_len)
    if res3 is not None:
        perm3, grouped3, grow3, glen3, row_group_native = res3
        ps = PanelSortResult(
            perm=perm3,
            panel_of_row=None,  # unused downstream; numpy path fills it
            group_row=grow3,
            group_len=glen3,
            is_grouped=grouped3,
        )
    else:
        ps = panel_sort(
            lens1, panel_bounds, group_width=cfg.group_width, max_len=cfg.max_group_row_len
        )

    # --- permutation algebra (reference wbsort.h:58-67,16-34) -----------------
    # one fused native pass: compose, invert, final-order indptr (int32
    # perms end-to-end — the container stores int32)
    orig_indptr = np.asarray(h.indptr, dtype=np.int64)
    res_pa = native.perm_algebra(perm1, ps.perm, orig_indptr)
    if res_pa is not None:
        row_perm, row_inv, indptr_final = res_pa
        # the numpy pack fallback below needs per-final-row lengths too
        lens_final = indptr_final[1:] - indptr_final[:-1]
    else:
        row_perm = np.asarray(perm1, dtype=np.int64)[ps.perm]  # final -> original
        row_inv = np.empty(nrow, dtype=np.int32)  # original row -> final_pos
        row_inv[row_perm] = np.arange(nrow, dtype=np.int32)
        lens_final = (orig_indptr[1:] - orig_indptr[:-1])[row_perm]
        indptr_final = np.zeros(nrow + 1, dtype=np.int64)
        np.cumsum(lens_final, out=indptr_final[1:])
    nnz = A.nnz
    grouped = ps.is_grouped  # per final row
    W = cfg.group_width
    if row_group_native is not None and W == 8:
        group_of_row = row_group_native
    else:
        grouped_rank = np.cumsum(grouped) - 1  # rank among grouped rows
        group_of_row = np.where(grouped, grouped_rank // W, -1)
    nregions = len(region_bounds) - 1
    region_nnz = indptr_final[region_bounds]

    # --- pass 3c: gather + v8 interleave + relabel -----------------------------
    res = None
    if W == 8:  # the native pass hardwires the 8-row group width
        res = native.pack_blocked(
            orig_indptr,
            np.asarray(h.indices[:nnz]),
            np.asarray(h.data[:nnz]),
            row_perm,
            indptr_final,
            group_of_row,
            region_bounds,
            ncol,
        )
    if res is not None:
        # native outputs are already int32 — keep them (i32() below is a
        # no-copy asarray for matching dtypes)
        packed_data, cols_local, gather_cols, counts = res
        region_gather = np.zeros(nregions + 1, dtype=np.int64)
        np.cumsum(counts, out=region_gather[1:])
    else:
        pos = np.arange(nnz, dtype=np.int64)
        row_of_pos = np.repeat(np.arange(nrow, dtype=np.int64), lens_final)
        src = orig_indptr[row_perm[row_of_pos]] + (pos - indptr_final[row_of_pos])
        data2 = np.asarray(h.data)[src]
        cols2 = np.asarray(h.indices, dtype=np.int64)[src]

        # v8 interleave: dest = base + 8*e + r within each group's 8L block
        grouped_rank = np.cumsum(grouped) - 1
        rr_of_row = np.where(grouped, grouped_rank % W, 0)
        group_base = indptr_final[ps.group_row] if ps.group_row.size else np.zeros(0, np.int64)
        g = group_of_row[row_of_pos]
        in_group_nnz = g >= 0
        e = pos - indptr_final[row_of_pos]
        dest = np.where(
            in_group_nnz,
            group_base[np.maximum(g, 0)] + W * e + rr_of_row[row_of_pos],
            pos,
        )
        packed_data = np.empty_like(data2)
        packed_cols = np.empty_like(cols2)
        packed_data[dest] = data2
        packed_cols[dest] = cols2
        cols_local, gather_cols, region_gather = _relabel(
            packed_cols, region_nnz, nregions, ncol
        )

    # --- seq_input: per-slot RHS row position for self-referential A×A --------
    if nrow == ncol:
        gather_rows = row_inv[gather_cols]
    else:
        gather_rows = gather_cols.copy()

    group_region = (
        np.searchsorted(region_bounds, ps.group_row, side="right") - 1
        if ps.group_row.size
        else np.zeros(0, np.int64)
    )

    i32 = lambda a: np.asarray(a, dtype=np.int32)
    return BlockedCSR(
        data=packed_data,
        cols_local=i32(cols_local),
        indptr=i32(indptr_final),
        row_perm=i32(row_perm),
        row_inv=i32(row_inv),
        region_rows=i32(region_bounds),
        region_nnz=i32(region_nnz),
        gather_cols=i32(gather_cols),
        region_gather=i32(region_gather),
        gather_rows=i32(gather_rows),
        group_row=i32(ps.group_row),
        group_len=i32(ps.group_len),
        group_nnz=i32(indptr_final[ps.group_row] if ps.group_row.size else np.zeros(0)),
        group_region=i32(group_region),
        row_group=i32(group_of_row),
        shape=(nrow, ncol),
        nnz=nnz,
        nregions=nregions,
        ngroups=int(ps.group_row.size),
        ndistinct=int(len(gather_cols)),
    )


def unpack_to_csr(B: BlockedCSR) -> CSR:
    """Inverse of ``preprocess`` — reconstructs the original CSR (rows in
    original order, columns sorted).  pack ∘ unpack == identity is the core
    format-correctness property (SURVEY.md §4.1)."""
    h = B.host()
    nrow, ncol = B.shape
    nnz = B.nnz
    indptr = np.asarray(h.indptr, dtype=np.int64)
    pos = np.arange(nnz, dtype=np.int64)
    row_of_pos = np.searchsorted(indptr, pos, side="right") - 1

    # undo relabel
    region_nnz = np.asarray(h.region_nnz, dtype=np.int64)
    region_of_pos = np.searchsorted(region_nnz, pos, side="right") - 1
    slot = (
        np.asarray(h.region_gather, dtype=np.int64)[region_of_pos]
        + np.asarray(h.cols_local, dtype=np.int64)[:nnz]
    )
    cols_global = np.asarray(h.gather_cols, dtype=np.int64)[slot]

    # undo the v8 interleave: rebuild per-position source index
    W = 8
    group_row = np.asarray(h.group_row, dtype=np.int64)
    group_len = np.asarray(h.group_len, dtype=np.int64)
    group_nnz = np.asarray(h.group_nnz, dtype=np.int64)
    group_of_row = np.asarray(h.row_group, dtype=np.int64)
    g = group_of_row[row_of_pos]
    ing = g >= 0
    # position within the group's 8L block
    off = pos - np.where(ing, group_nnz[np.maximum(g, 0)], 0)
    e, rr = off // W, off % W
    # packed slot (8e + r) came from row (group_row+rr), element e
    src_row = np.where(ing, group_row[np.maximum(g, 0)] + rr, row_of_pos)
    src_e = np.where(ing, e, pos - indptr[row_of_pos])

    orig_row = np.asarray(h.row_perm, dtype=np.int64)[src_row]
    coo = COO(
        row=orig_row.astype(np.int32),
        col=cols_global.astype(np.int32),
        data=np.asarray(h.data[:nnz]),
        shape=(nrow, ncol),
        nnz=nnz,
    )
    del src_e
    return to_csr(coo, sort_within_row=True, sum_duplicates=False)
