"""SpGEMM — sparse × sparse, exact (port of ``spmm_tpu/ops/spgemm.py``).

The expand/sort/merge (ESC) algorithm: one gather expands every partial
product, one stable ``torch.sort`` on a 64-bit ``row * ncol + col`` key orders
them, and one ordered segment sum (``ops/segments.py``) merges duplicates,
the same bits on every run.  The expansion size is
computed exactly on the host (O(nnz)), and a row-chunked driver bounds the
device memory of huge products.  ``indptr``/``indices`` of the result are
exact; data is the sum of the partial products in the values' dtype (integer
counts, exact, for pattern matrices).

The production SpGEMM, ``ops.spgemm``, is the slab-sorted kernel
(``ops/slab_spgemm.py``); it sends its heavy-tail rows here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spmm_tpu_torch.formats.containers import COO, CSR, as_numpy, as_tensor, compute_device, to_csr
from spmm_tpu_torch.ops.segments import SegmentPlan, boundary_segments, segment_sum

_INVALID = torch.iinfo(torch.int64).max


def spgemm_expand_bound(A: CSR, B: CSR) -> int:
    """Exact number of partial products Σ_{(i,j)∈A} nnz(B row j) — the ESC
    expansion size (= FLOPs/2 of the product)."""
    Ah, Bh = A.host(), B.host()
    lb = np.asarray(Bh.indptr[1:], dtype=np.int64) - np.asarray(Bh.indptr[:-1], dtype=np.int64)
    return int(lb[np.asarray(Ah.indices[: A.nnz], dtype=np.int64)].sum())


def spgemm_coo_padded(
    A: CSR, B: CSR, expand_size: int, *, device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """ESC SpGEMM with an expansion bound, on ``device``.

    Returns ``(rows, cols, vals, out_nnz)``: int32/int32/value-dtype arrays of length
    ``expand_size`` (entries at positions ``>= out_nnz`` are zero padding)
    and a 0-d int64 tensor.  ``expand_size`` must be >=
    ``spgemm_expand_bound(A, B)``.
    """
    ncol = B.shape[1]
    t = lambda a: as_tensor(a, device)
    a_ind = t(A.indices).long().clamp(0, B.shape[0] - 1)
    a_dat = t(A.data)
    b_indptr = t(B.indptr).long()
    b_ind = t(B.indices).long()
    b_dat = t(B.data)

    # ---- expand: one slot per partial product --------------------------------
    pos = torch.arange(A.nnz_pad, device=device)
    a_rows = boundary_segments(t(A.indptr), A.nnz_pad, dtype=torch.int64)
    lb = b_indptr[1:] - b_indptr[:-1]
    counts = torch.where(pos < A.nnz, lb[a_ind], 0)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    total = offsets[-1]

    e = torch.arange(expand_size, device=device)
    src = boundary_segments(offsets, expand_size, dtype=torch.int64)
    valid = e < total
    bidx = (b_indptr[a_ind[src]] + (e - offsets[src])).clamp(0, B.nnz_pad - 1)
    key = torch.where(valid, a_rows[src] * ncol + b_ind[bidx], _INVALID)
    val = torch.where(valid, a_dat[src] * b_dat[bidx], 0)

    # ---- sort by (row, col), merge duplicates ---------------------------------
    ks, order = torch.sort(key, stable=True)
    vs = val[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    seg = torch.cumsum(first, 0) - 1
    marks = torch.arange(expand_size + 1, device=device)
    vals = segment_sum(vs, plan=SegmentPlan(torch.searchsorted(seg, marks), None))
    ukey = torch.zeros(expand_size, dtype=torch.int64, device=device).scatter_(0, seg, ks)
    out_nnz = (first & (ks != _INVALID)).sum()
    # scrub the invalid segment (all-invalid keys merge into one slot at out_nnz)
    keep = e < out_nnz
    rows = torch.where(keep, ukey // ncol, 0).to(torch.int32)
    cols = torch.where(keep, ukey % ncol, 0).to(torch.int32)
    vals = torch.where(keep, vals, 0)
    return rows, cols, vals, out_nnz


def spgemm(
    A: CSR,
    B: CSR,
    *,
    device="cuda",
    max_expand_per_chunk: int = 64 * 1024 * 1024,
    as_csr: bool = True,
):
    """Global-sort ESC driver: exact host sizing, row chunks of at most
    ``max_expand_per_chunk`` partial products (one row may exceed it alone),
    the ESC of each chunk on ``device`` (the card unless the caller names
    another), host concatenation.  B may be host- or ``device``-held.
    Returns a host CSR (or COO), its data in the dtype of A's and B's values
    promoted, an empty product's too."""
    device = compute_device(device)
    if A.nnz == 0 or B.nnz == 0:
        # the dtype the expansion's multiply gives A's and B's values
        dt = torch.promote_types(as_tensor(A.data[:0], "cpu").dtype, as_tensor(B.data[:0], "cpu").dtype)
        out = COO(
            row=np.zeros(0, np.int32),
            col=np.zeros(0, np.int32),
            data=torch.empty(0, dtype=dt).numpy(),
            shape=(A.nrow, B.ncol),
            nnz=0,
        )
        return to_csr(out) if as_csr else out
    Ah = A.host()
    lbB = as_numpy(B.indptr).astype(np.int64)  # B may lie on the device: its indptr alone
    lb = lbB[1:] - lbB[:-1]
    a_ind = np.asarray(Ah.indices[: A.nnz], dtype=np.int64)
    per_nnz = lb[a_ind]
    indptr = np.asarray(Ah.indptr, dtype=np.int64)
    # expansion prefix per row boundary: exp_prefix[i] = partial products of rows < i
    row_ids = np.searchsorted(indptr, np.arange(A.nnz, dtype=np.int64), side="right") - 1
    row_exp = np.zeros(A.nrow, dtype=np.int64)
    np.add.at(row_exp, row_ids, per_nnz)
    exp_prefix = np.zeros(A.nrow + 1, dtype=np.int64)
    np.cumsum(row_exp, out=exp_prefix[1:])

    # choose row chunk boundaries so each chunk's expansion fits the budget
    cuts = [0]
    while cuts[-1] < A.nrow:
        start = cuts[-1]
        target = exp_prefix[start] + max_expand_per_chunk
        end = int(np.searchsorted(exp_prefix, target, side="right")) - 1
        end = max(end, start + 1)
        cuts.append(min(end, A.nrow))
    Bd = B.pad(8).to(device)

    rows_all, cols_all, vals_all = [], [], []
    for s, t in zip(cuts[:-1], cuts[1:]):
        lo, hi = int(indptr[s]), int(indptr[t])
        sub = CSR(
            data=np.asarray(Ah.data[lo:hi]),
            indices=np.asarray(Ah.indices[lo:hi], dtype=np.int32),
            indptr=(indptr[s : t + 1] - lo).astype(np.int32),
            shape=(t - s, A.ncol),
            nnz=hi - lo,
        ).pad(8)
        bound = int(exp_prefix[t] - exp_prefix[s])
        r, c, v, k = spgemm_coo_padded(sub, Bd, max(bound, 1), device=device)
        k = int(k)
        rows_all.append(r[:k].cpu().numpy() + s)
        cols_all.append(c[:k].cpu().numpy())
        vals_all.append(v[:k].cpu().numpy())

    rows = np.concatenate(rows_all)
    cols = np.concatenate(cols_all)
    vals = np.concatenate(vals_all)
    out = COO(
        row=rows.astype(np.int32),
        col=cols.astype(np.int32),
        data=vals,
        shape=(A.nrow, B.ncol),
        nnz=int(len(rows)),
    )
    if as_csr:
        # already row-major sorted with unique keys; direct CSR assembly
        return to_csr(out, sort_within_row=False, sum_duplicates=False)
    return out


#: the global-sort path's name in ``ops`` (``ops.spgemm`` is the slab kernel)
spgemm_sorted = spgemm
