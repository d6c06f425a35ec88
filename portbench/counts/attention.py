"""Least bytes of a graph-transformer training step (``calls/graph_transformer.py``):
every operation's inputs read once and its outputs written once, in float32
with an int32 CSR structure, as ``counts/bytes.py`` counts a product.  A
sparse operation over H heads reads A's structure once and H values a slot,
whatever a kernel reads again; a dense operand counts only its rows that some
entry reads.  The dense operations count as the step runs them: the three
projections in one product, the skip product adding the heads' concatenation,
the ReLU, the head, the loss over the train nodes."""

from __future__ import annotations

from portbench.counts.bytes import csr_bytes


def sddmm(n: int, nnz: int, width: int, heads: int, a_rows: int, b_rows: int, *, val: int = 4) -> int:
    """S_ij = <A_i, B_j> per head on A's entries: the structure, the rows of
    A and B (``width`` = heads × head width) that entries name, and ``heads``
    values an entry written."""
    return csr_bytes(n, nnz, values=False) + (a_rows + b_rows) * width * val + nnz * heads * val


def spmm(n: int, nnz: int, width: int, heads: int, read_rows: int, out_rows: int, *, val: int = 4) -> int:
    """Y = A(values)·B per head: the structure and ``heads`` values an entry
    read, the ``read_rows`` rows of B read, ``out_rows`` rows of Y written."""
    return csr_bytes(n, nnz, values=False) + nnz * heads * val + (read_rows + out_rows) * width * val


def softmax(nnz: int, heads: int, *, val: int = 4) -> int:
    """α from S over each row's entries: S read, α written."""
    return 2 * nnz * heads * val


def softmax_backward(nnz: int, heads: int, *, val: int = 4) -> int:
    """dS from α and dα: both read, dS written."""
    return 3 * nnz * heads * val


def step(n: int, nnz: int, *, layers: int, in_features: int, heads: int, head_dim: int, classes: int,
         train_nodes: int, col_rows: int, row_rows: int, val: int = 4) -> int:
    """The whole step: forward, the loss, and the backward to every weight
    (not to the input features).  ``col_rows``: the rows that some column of
    A names; ``row_rows``: the rows of A with an entry."""
    w = heads * head_dim
    total = 0
    for i in range(layers):
        f = in_features if i == 0 else w
        # forward: Q, K, V; scores; softmax; aggregation; skip + heads; ReLU
        total += (n * f + 3 * n * w + 3 * w * (f + 1)) * val
        total += sddmm(n, nnz, w, heads, row_rows, col_rows, val=val)
        total += softmax(nnz, heads, val=val)
        total += spmm(n, nnz, w, heads, col_rows, n, val=val)
        total += (2 * n * w + n * f + w * (f + 1)) * val
        if i + 1 < layers:
            total += 2 * n * w * val
        # backward: ReLU; skip's weight and input; dα and dV; the softmax;
        # dQ and dK; the projections' weights and input
        if i + 1 < layers:
            total += 3 * n * w * val
        total += (n * w + n * f + w * (f + 1)) * val
        total += sddmm(n, nnz, w, heads, row_rows, col_rows, val=val)
        total += spmm(n, nnz, w, heads, row_rows, n, val=val)
        total += softmax_backward(nnz, heads, val=val)
        total += spmm(n, nnz, w, heads, col_rows, n, val=val)
        total += spmm(n, nnz, w, heads, row_rows, n, val=val)
        total += (3 * n * w + n * f + 3 * w * (f + 1)) * val
        if i:
            total += (n * w + n * f) * val + (3 * n * w + n * f) * val
    # the head, forward and backward (its weight and input), the loss
    total += (n * w + n * classes + classes * (w + 1)) * val
    total += (2 * train_nodes * classes + train_nodes) * val
    total += (n * classes + n * w + classes * (w + 1)) * val + (n * classes + n * w) * val
    return total
