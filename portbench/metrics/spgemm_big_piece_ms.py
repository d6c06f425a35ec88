"""Host time of the pieces a call: the spans ``spmm.spgemm.big.piece``
(``ops/slab_spgemm.py: spgemm_slab_big``, one per piece: its copy to the
card, ``_piece_csr``'s tables, K4 (b), K5, the wait and ``_csr_to_host``'s
landing), summed."""

from portbench.spans import ms_per_call


def read(trace, counts):
    return ms_per_call(trace, "spmm.spgemm.big.piece")
