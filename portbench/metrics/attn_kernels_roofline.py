"""Share of a graph-transformer step's least time in its kernel time: the
least bytes (``counts/attention.py``) of everything the step computes (the
projections, the scores, the edge softmax, the aggregation, the head and the
loss, and the backward of each) at the H100 SXM's HBM rate, over the summed
time of every kernel the step launches (the dense products and element-wise
ones too)."""

from portbench.counts.peaks import HBM_BYTES_PER_S


def read(trace, counts):
    least = counts.get("attn_least_bytes")
    kernel_s = trace.seconds(lambda kind, name: kind == "kernel")
    if not least or not trace.calls or kernel_s <= 0:
        return None
    return 100.0 * (least / HBM_BYTES_PER_S) / (kernel_s / trace.calls)
