"""Host time of the SpMM's own layers a training step: the spans
``spmm.ell_spmm`` (the entry: row maps, leftover rows, the forward launch),
``spmm.ell.transposed`` (grad X, K2 on Aᵀ) and ``spmm.ell.sddmm`` (grad
values, K3), summed over the threads that record them."""

from portbench.spans import ms_per_call


def read(trace, counts):
    return ms_per_call(trace, "spmm.ell_spmm", "spmm.ell.transposed", "spmm.ell.sddmm")
