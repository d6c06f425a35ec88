"""Host time of the copy of C to the host a call: the span
``spmm.spgemm.to_host`` (``ops/slab_spgemm.py: _csr_to_host``), the host's
side of the copy whose device side ``spgemm_d2h_ms`` reads."""

from portbench.spans import ms_per_call


def read(trace, counts):
    return ms_per_call(trace, "spmm.spgemm.to_host")
