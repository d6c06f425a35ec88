"""The program's spans in a traced window: the host events that
``spmm_tpu_torch.utils.profiling.span`` records (``spmm.*`` names) while the
profiler runs, on any thread (autograd's backward thread too), summed by
name.  A program without spans records none, and the readers built on these
functions then return None."""

from __future__ import annotations

import numpy as np


def host_events(trace, names) -> tuple:
    """(summed nanoseconds, count) of the window's host events named one of
    ``names``, clipped to the window as the trace holds them."""
    wanted = set(names)
    sel = np.fromiter((n in wanted for n in trace.host_name), bool, len(trace.host_name))
    return int((trace.host_end[sel] - trace.host_start[sel]).sum()), int(sel.sum())


def ms_per_call(trace, *names) -> float | None:
    """Milliseconds a call of the spans named ``names``, summed; None where
    the window holds none of them."""
    ns, count = host_events(trace, names)
    if not count or not trace.calls:
        return None
    return 1e-6 * ns / trace.calls

