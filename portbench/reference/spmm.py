"""One SpMM training step, Y = A·X, loss = Σ Y², and its gradients with
respect to X and to A's values, by gathers and ``index_add_``.

Entries are taken in blocks of ``block``, so that the gathered rows
(block × k) fit beside anything on the device."""

from __future__ import annotations

import torch


def train_step(indptr, indices, data, X, *, dtype=torch.float64, block: int = 1 << 18):
    """A dict of float64 tensors on X's device (each computed in ``dtype``):
    ``loss``; ``y`` (m × k), ``gx`` (n × k) and ``gv`` (one per entry, in
    CSR order); and beside each of the last three its ``*_scale``, the sum
    of the absolute values of the terms of each element (with 2·``y_scale``
    standing for |dY|, the bound of dY's own rounding)."""
    dev = X.device
    ptr = indptr.long()
    m, nnz = len(ptr) - 1, int(ptr[-1])
    rows = torch.repeat_interleave(torch.arange(m, device=dev), ptr[1:] - ptr[:-1])
    cols = indices[:nnz].long()
    a, a_abs = data[:nnz].to(dtype), data[:nnz].double().abs()
    x, x_abs = X.to(dtype), X.double().abs()
    n, k = X.shape
    y = torch.zeros((m, k), dtype=dtype, device=dev)
    y_scale = torch.zeros((m, k), dtype=torch.float64, device=dev)
    spans = [(s, min(s + block, nnz)) for s in range(0, nnz, block)]
    for s, e in spans:
        y.index_add_(0, rows[s:e], a[s:e, None] * x[cols[s:e]])
        y_scale.index_add_(0, rows[s:e], a_abs[s:e, None] * x_abs[cols[s:e]])
    loss = (y * y).sum()
    dy = 2 * y
    # dY's own rounding is bounded by its scale, so the gradients' terms are
    # measured with |dY| at that bound
    dy_abs = 2 * y_scale
    gx = torch.zeros((n, k), dtype=dtype, device=dev)
    gx_scale = torch.zeros((n, k), dtype=torch.float64, device=dev)
    gv = torch.empty(nnz, dtype=dtype, device=dev)
    gv_scale = torch.empty(nnz, dtype=torch.float64, device=dev)
    for s, e in spans:
        gx.index_add_(0, cols[s:e], a[s:e, None] * dy[rows[s:e]])
        gx_scale.index_add_(0, cols[s:e], a_abs[s:e, None] * dy_abs[rows[s:e]])
        gv[s:e] = (dy[rows[s:e]] * x[cols[s:e]]).sum(1)
        gv_scale[s:e] = (dy_abs[rows[s:e]] * x_abs[cols[s:e]]).sum(1)
    return {"loss": loss.double(), "y": y.double(), "y_scale": y_scale, "gx": gx.double(),
            "gx_scale": gx_scale, "gv": gv.double(), "gv_scale": gv_scale}
