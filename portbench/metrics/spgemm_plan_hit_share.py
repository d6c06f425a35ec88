"""Share of the calls that found their plan in the plan cache, in %: the
marker spans ``spmm.spgemm.plan_hit`` over the window's calls; 0 where the
program records its spans (``spmm.spgemm``) and no call hits, None where it
records none."""

from portbench.spans import host_events


def read(trace, counts):
    if not host_events(trace, ("spmm.spgemm",))[1] or not trace.calls:
        return None
    return 100.0 * host_events(trace, ("spmm.spgemm.plan_hit",))[1] / trace.calls
