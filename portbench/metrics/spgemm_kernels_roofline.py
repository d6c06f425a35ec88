"""Share of the SpGEMM's least time in the kernel time of a call: A's and
C's device-form bytes (``counts/bytes.py: spgemm``), each read or written
once, at the H100 SXM's HBM rate, over the summed time of every kernel the
call launches (the sizing's, K4's and K5's alike; copies and memsets
not counted)."""

from portbench.counts.peaks import HBM_BYTES_PER_S


def read(trace, counts):
    least = counts.get("spgemm_least_bytes")
    kernel_s = trace.seconds(lambda kind, name: kind == "kernel")
    if not least or not trace.calls or kernel_s <= 0:
        return None
    return 100.0 * (least / HBM_BYTES_PER_S) / (kernel_s / trace.calls)
