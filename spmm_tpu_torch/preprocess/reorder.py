"""Pass 1 — dominant-section row reordering (port of
``spmm_tpu/preprocess/reorder.py``: the host path and the torch device path).

Redesign of the reference's bitmap reorder (reference: bitmap.h:108-170,
invoked with SECT=2048 at serial_newblock_clock.cpp:246).  Split the column
space into fixed-width sections; cluster rows whose nonzeros concentrate in
the same section so that nearby rows share an RHS working set.  With CSR
columns sorted, the dominant section is the section holding the most of the
row's nonzeros (ties → lowest section).  Rows with no nonzeros go to bucket 0.
The permutation only affects locality, never numeric results.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spmm_tpu_torch import native
from spmm_tpu_torch.formats.containers import CSR, as_tensor, device_of, permute_rows
from spmm_tpu_torch.ops.segments import boundary_segments


def dominant_sections(A: CSR, section_size: int = 2048) -> np.ndarray:
    """Per-row dominant section id, or -1 for empty rows.

    Uses the native O(nnz) scan when available (CSR columns are sorted within
    rows by construction); otherwise a vectorized numpy formulation.
    """
    h = A.host()
    nrow = A.shape[0]
    if A.nnz == 0:
        return np.full(nrow, -1, dtype=np.int64)
    dom = native.dominant_sections(
        np.asarray(h.indptr, dtype=np.int64), np.asarray(h.indices[: A.nnz]), section_size
    )
    if dom is not None:
        return dom
    lens = np.asarray(h.row_lengths(), dtype=np.int64)
    rows = np.repeat(np.arange(nrow, dtype=np.int64), lens)
    cols = np.asarray(h.indices[: A.nnz], dtype=np.int64)
    sect = cols // section_size
    nsect = int((A.shape[1] + section_size - 1) // section_size)

    key = rows * nsect + sect
    uniq, counts = np.unique(key, return_counts=True)
    urow, usect = uniq // nsect, uniq % nsect
    # per row: max count, tie -> lowest section.  lexsort: last key is primary.
    order = np.lexsort((-usect, counts, urow))
    urow_s, usect_s = urow[order], usect[order]
    last = np.nonzero(np.concatenate([urow_s[1:] != urow_s[:-1], np.ones(1, bool)]))[0]
    dom = np.full(nrow, -1, dtype=np.int64)
    dom[urow_s[last]] = usect_s[last]
    return dom


def bitmap_reorder(
    A: CSR, section_size: int = 2048, *, materialize: bool = True
) -> Tuple[CSR | None, np.ndarray]:
    """Returns ``(A_permuted | None, perm)`` with ``perm[new_pos] = old_row``:
    rows stably bucketed by dominant section (bucket 0 = empty rows)."""
    dom = dominant_sections(A, section_size)
    nsect = int((A.shape[1] + section_size - 1) // section_size)
    perm = native.counting_argsort(dom + 1, nsect + 1)
    if perm is None:
        perm = np.argsort(dom + 1, kind="stable")
    out = permute_rows(A, perm) if materialize else None
    return out, perm


# ------------------------------------------------------------------------------
# device path
# ------------------------------------------------------------------------------


def dominant_sections_device(
    indices: torch.Tensor, indptr: torch.Tensor, nnz: int, shape: Tuple[int, int],
    section_size: int,
) -> torch.Tensor:
    """Per-row dominant section id (int64), or -1 for empty rows, in torch on
    the tensors' device.  Sort the per-nonzero keys ``row * nsect + sect``
    (one int64 key: no overflow below 2^63); run lengths of equal keys are
    the per-(row, section) counts; an ``amax`` scatter takes each row's best
    count and an ``amin`` scatter the lowest section reaching it."""
    nrow, ncol = shape
    nsect = (ncol + section_size - 1) // section_size
    dev = indices.device
    rows = boundary_segments(indptr, nnz, dtype=torch.int64, device=dev)
    key = rows * nsect + indices[:nnz].long() // section_size
    runs, counts = torch.unique_consecutive(torch.sort(key).values, return_counts=True)
    run_rows, run_sects = runs // nsect, runs % nsect
    best_cnt = torch.full((nrow,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, run_rows, counts, "amax"
    )
    big = torch.iinfo(torch.int64).max
    sect_c = torch.where(counts == best_cnt[run_rows], run_sects, big)
    best_sect = torch.full((nrow,), big, dtype=torch.int64, device=dev).scatter_reduce_(
        0, run_rows, sect_c, "amin"
    )
    return torch.where(best_cnt < 0, -1, best_sect)


def bitmap_perm_device(A: CSR, section_size: int = 2048) -> torch.Tensor:
    """The permutation of :func:`bitmap_reorder` (new_pos → old_row, int32),
    computed in torch on the device of A's leaves (the CPU for numpy)."""
    dev = device_of(A.data)
    dom = dominant_sections_device(
        as_tensor(A.indices, dev), as_tensor(A.indptr, dev), A.nnz, A.shape, section_size
    )
    return torch.argsort(dom + 1, stable=True).to(torch.int32)
