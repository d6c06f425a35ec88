"""Pass 2 — region split by distinct-column working set.

Redesign of the reference's first-touch bitmap scan
(reference: transmat.h:334-376, threshold 512*1024/8 = 65536 distinct columns
sized for a 512 KB cache of doubles).  On TPU the same pass budgets the
per-region compacted RHS panel for VMEM: a region touching D distinct columns
needs a (D, k) panel resident on-chip (SURVEY.md §2.4).

Semantics (verified against the reference, SURVEY.md §2.4): scan rows in
order, counting first-touches of columns since the region began; once the
count reaches the budget, the region closes *after* the current row (so a
region may overshoot by one row's new columns), the bitmap resets, and the
next region begins.

The scan is inherently sequential in regions, but each nonzero is visited
exactly once, so a windowed vectorized sweep is O(nnz log nnz) total: take a
row window, compute within-window first-touch prefix counts via ``np.unique``,
cut, repeat from the cut.
"""

from __future__ import annotations

import numpy as np

from spmm_tpu_torch.formats.containers import CSR


def split_regions(A: CSR, budget: int = 65536, *, min_window_rows: int = 4096) -> np.ndarray:
    """Returns region row boundaries ``[0, r1, ..., nrow]`` (int64).

    Each region's distinct-column count reaches ``budget`` at most on its last
    row (i.e. ``distinct(region) < budget + nnz(last row)``).
    """
    h = A.host()
    nrow = A.shape[0]
    indptr = np.asarray(h.indptr, dtype=np.int64)
    from spmm_tpu_torch import native

    bounds_n = native.region_split(indptr, np.asarray(h.indices[: A.nnz]), A.shape[1], budget)
    if bounds_n is not None:
        return bounds_n
    cols = np.asarray(h.indices[: A.nnz], dtype=np.int64)
    bounds = [0]
    start = 0
    while start < nrow:
        # grow the window until it provably contains the cut (or the end)
        end = min(nrow, start + min_window_rows)
        while True:
            lo, hi = indptr[start], indptr[end]
            wcols = cols[lo:hi]
            # within-window first-touch marking
            new = np.zeros(hi - lo, dtype=np.int64)
            if hi > lo:
                _, first_idx = np.unique(wcols, return_index=True)
                new[first_idx] = 1
            cum = np.cumsum(new)
            # distinct count after each row in the window
            row_end_nnz = indptr[start + 1 : end + 1] - lo
            if hi > lo:
                distinct_after_row = np.where(
                    row_end_nnz > 0, cum[np.maximum(row_end_nnz, 1) - 1], 0
                )
            else:
                distinct_after_row = np.zeros(end - start, dtype=np.int64)
            hit = np.nonzero(distinct_after_row >= budget)[0]
            if hit.size:
                cut = start + int(hit[0]) + 1  # close AFTER the triggering row
                break
            if end == nrow:
                cut = nrow
                break
            end = min(nrow, start + (end - start) * 2)
        bounds.append(cut)
        start = cut
    return np.asarray(bounds, dtype=np.int64)


def region_distinct_counts(A: CSR, bounds: np.ndarray) -> np.ndarray:
    """Distinct-column count per region (for panel sizing / validation)."""
    h = A.host()
    indptr = np.asarray(h.indptr, dtype=np.int64)
    cols = np.asarray(h.indices[: A.nnz], dtype=np.int64)
    out = np.zeros(len(bounds) - 1, dtype=np.int64)
    for i, (s, t) in enumerate(zip(bounds[:-1], bounds[1:])):
        out[i] = np.unique(cols[indptr[s] : indptr[t]]).size
    return out
