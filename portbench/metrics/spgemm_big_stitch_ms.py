"""Host time of the stitch a call: the span ``spmm.spgemm.big.stitch``
(``ops/slab_spgemm.py: _stitch``, the pieces' triples concatenated into C on
the host)."""

from portbench.spans import ms_per_call


def read(trace, counts):
    return ms_per_call(trace, "spmm.spgemm.big.stitch")
