"""Host time of the SpGEMM's sizing a call: the span ``spmm.spgemm.sizing``
(``ops/slab_spgemm.py: _sizing``: the native sizing pass, the class fold and
the counting argsort), which runs before the plan lookup in every call."""

from portbench.spans import ms_per_call


def read(trace, counts):
    return ms_per_call(trace, "spmm.spgemm.sizing")
