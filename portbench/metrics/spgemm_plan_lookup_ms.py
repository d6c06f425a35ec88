"""Host time of the plan cache's lookup a call: the span
``spmm.spgemm.plan_lookup`` (``ops/slab_spgemm.py: _auto_plan_lookup``: the
key lookup and the operands' fingerprint, a sum over their values and
indices)."""

from portbench.spans import ms_per_call


def read(trace, counts):
    return ms_per_call(trace, "spmm.spgemm.plan_lookup")
