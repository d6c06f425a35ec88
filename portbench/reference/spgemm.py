"""C = A·B by expand, sort and compress.

Every partial product A[i, k]·B[k, j] is expanded, the products are sorted
by (i, j) and each run is summed.  The product is structural: an entry that
some pair reaches stays, even where its products cancel or a factor is an
explicit zero.  Rows are taken in blocks of at most ``block`` partial
products, so that the reference fits beside anything on the device."""

from __future__ import annotations

import torch


def spgemm(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, ncol: int, *,
           dtype=torch.float64, block: int = 1 << 24):
    """``(indptr, indices, data, scale)`` of C = A·B as int64 / int64 /
    ``dtype`` / float64 tensors on the inputs' device.  ``scale`` is
    Σ_k |A[i, k]|·|B[k, j]| per entry, in float64: the size against which
    an entry's rounding is measured.  Inputs are CSR tensors, columns
    ascending in each row or not."""
    dev = a_indptr.device
    a_ptr, b_ptr = a_indptr.long(), b_indptr.long()
    a_idx, b_idx = a_indices.long(), b_indices.long()
    a_val, b_val = a_data.to(dtype), b_data.to(dtype)
    a_abs, b_abs = a_data.double().abs(), b_data.double().abs()
    nrow = len(a_ptr) - 1
    b_len = b_ptr[1:] - b_ptr[:-1]
    # partial products per row of A, and the row blocks that hold ``block``
    per_entry = b_len[a_idx[: int(a_ptr[-1])]]
    cum = torch.zeros(len(per_entry) + 1, dtype=torch.long, device=dev)
    torch.cumsum(per_entry, 0, out=cum[1:])
    row_cum = cum[a_ptr]  # partial products before each row
    bounds = [0]
    while bounds[-1] < nrow:
        lo = bounds[-1]
        hi = int(torch.searchsorted(row_cum, row_cum[lo] + block, right=True)) - 1
        bounds.append(min(max(hi, lo + 1), nrow))
    counts, cols, vals, scales = [], [], [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        e0, e1 = int(a_ptr[lo]), int(a_ptr[hi])
        cnt = per_entry[e0:e1]
        row = torch.repeat_interleave(torch.arange(lo, hi, device=dev), a_ptr[lo + 1 : hi + 1] - a_ptr[lo:hi]) - lo
        rep = torch.repeat_interleave(torch.arange(e1 - e0, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        src = b_ptr[a_idx[e0:e1]][rep] + torch.arange(len(rep), device=dev) - first[rep]
        col = b_idx[src]
        key, order = torch.sort(row[rep] * ncol + col)
        uniq, run = torch.unique_consecutive(key, return_counts=True)
        seg = torch.repeat_interleave(torch.arange(len(uniq), device=dev), run)
        rep, src = rep[order], src[order]
        v = torch.zeros(len(uniq), dtype=dtype, device=dev)
        v.index_add_(0, seg, a_val[e0:e1][rep] * b_val[src])
        s = torch.zeros(len(uniq), dtype=torch.float64, device=dev)
        s.index_add_(0, seg, a_abs[e0:e1][rep] * b_abs[src])
        counts.append(torch.bincount(uniq // ncol, minlength=hi - lo))
        cols.append(uniq % ncol)
        vals.append(v)
        scales.append(s)
    indptr = torch.zeros(nrow + 1, dtype=torch.long, device=dev)
    if counts:
        torch.cumsum(torch.cat(counts), 0, out=indptr[1:])
    cat = lambda xs, dt: torch.cat(xs) if xs else torch.zeros(0, dtype=dt, device=dev)
    return indptr, cat(cols, torch.long), cat(vals, dtype), cat(scales, torch.float64)
