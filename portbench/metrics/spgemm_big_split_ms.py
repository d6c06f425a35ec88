"""Host time of the piece split a call: the spans ``spmm.spgemm.big.split``
(``ops/slab_spgemm.py: _choose_pieces``, one per round of the piece search:
``partition_rows`` and each piece's host sizing), summed."""

from portbench.spans import ms_per_call


def read(trace, counts):
    return ms_per_call(trace, "spmm.spgemm.big.split")
