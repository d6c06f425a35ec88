"""Host work of the attention ops a training step: the time inside the spans
``spmm.attn.scores`` (``ops.ell_sddmm``: the layout lookup, K3's launch, the
padding's mask and the leftover rows' gathers), ``spmm.attn.softmax``
(``ops.ell_edge_softmax``: its per-slab row reductions), and their backward
routes ``spmm.attn.scores_bwd`` (K2 with the row map, K2 on the transposed
pack) and ``spmm.attn.softmax_bwd``, summed over the threads that record
them, less the time those threads spend there inside CUDA runtime and driver
calls (``cuda*``, ``cu*``; ``Command Buffer Full``).  Once the card is busy
the host blocks inside a launch until the launch queue has room, so the
spans' whole time follows the device's; what is left is the Python and the
operators' dispatch, which a host regression moves and a busy card does
not."""

import re

import numpy as np

SPANS = ("spmm.attn.scores", "spmm.attn.softmax", "spmm.attn.scores_bwd", "spmm.attn.softmax_bwd")
#: host events of the CUDA runtime and driver, and the profiler's mark of a full launch queue
RUNTIME = re.compile(r"cu(da)?[A-Z]|Command Buffer Full")


def read(trace, counts):
    names = trace.host_name
    span = np.fromiter((n in SPANS for n in names), bool, len(names))
    if not span.any() or not trace.calls:
        return None
    runtime = np.fromiter((RUNTIME.match(n) is not None for n in names), bool, len(names))
    ns = 0
    for thread in np.unique(trace.host_thread[span]):
        on = trace.host_thread == thread
        s, e = trace.host_start[span & on], trace.host_end[span & on]
        ws, we = _union(trace.host_start[runtime & on], trace.host_end[runtime & on])
        ns += int((e - s).sum()) - int((_covered(e, ws, we) - _covered(s, ws, we)).sum())
    return 1e-6 * ns / trace.calls


def _union(s: np.ndarray, e: np.ndarray):
    """The union of the intervals [s, e) as sorted disjoint (start, end) arrays."""
    if len(s) == 0:
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    last = np.r_[np.flatnonzero(new)[1:] - 1, len(s) - 1]
    return s[new], e[last]


def _covered(t: np.ndarray, ws: np.ndarray, we: np.ndarray) -> np.ndarray:
    """The time of the disjoint sorted intervals (ws, we) before each time in ``t``."""
    if len(ws) == 0:
        return np.zeros(len(t), np.int64)
    before = np.r_[0, np.cumsum(we - ws)]
    i = np.searchsorted(ws, t, side="right")
    j = np.maximum(i - 1, 0)
    part = np.where(i > 0, np.clip(t - ws[j], 0, we[j] - ws[j]), 0)
    return before[j] * (i > 0) + part
