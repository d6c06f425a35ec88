"""Segment-id expansion primitive (``spmm_tpu/ops/segments.py``).

Expanding sorted boundaries into per-element segment ids with one scatter-add
and one cumsum: O(n) streaming work, no binary search.
"""

from __future__ import annotations

import torch

from spmm_tpu_torch.formats.containers import as_tensor


def boundary_segments(boundaries, out_size: int, *, dtype=torch.int32, device=None) -> torch.Tensor:
    """For sorted ``boundaries`` with ``boundaries[0] == 0``, returns
    ``seg[e] = searchsorted(boundaries, e, side="right") - 1`` for
    ``e in [0, out_size)``, except that positions at/after ``boundaries[-1]``
    saturate at ``len(boundaries) - 2`` (the last segment).

    ``boundary_segments(indptr, nnz_pad)`` is CSR indptr → per-nonzero row ids.
    The result lies on ``device`` (default: that of ``boundaries``, the CPU
    for a numpy array).
    """
    if device is None:
        device = boundaries.device if isinstance(boundaries, torch.Tensor) else "cpu"
    b = as_tensor(boundaries, device).to(torch.int64)[1:-1]
    b = b[b < out_size]  # out-of-range boundaries are dropped, as a scatter with mode="drop"
    z = torch.zeros((out_size,), dtype=torch.int64, device=device)
    z.index_add_(0, b, torch.ones_like(b))
    return torch.cumsum(z, 0).to(dtype)
