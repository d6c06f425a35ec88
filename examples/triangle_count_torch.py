"""Triangle counting on an undirected graph with the PyTorch/CUDA port -- the
A×A SpGEMM workload with graph-analytic semantics (the counterpart of
examples/triangle_count.py, same functions and arguments).

For a simple undirected graph with 0/1 symmetric adjacency A:

    triangles = sum(A ∘ (A @ A)) / 6

i.e. count, over every edge (i, j), the common neighbors of i and j -- each
triangle is seen 6 times (3 edges × 2 directions).  A@A runs on the card via
the slab SpGEMM ``ops.spgemm`` (pattern mode engages automatically: all
values are 1.0); the edge-masked sum is a per-row sorted merge join on host.

Run:  python examples/triangle_count_torch.py [--n 100000] [--nnz 600000]
      (on an NVIDIA GPU; add --device cpu to run on the CPU)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def symmetrize(A):
    """A ∨ Aᵀ with unit values and an empty diagonal (simple graph)."""
    from spmm_tpu_torch.formats.containers import CSR

    S = A.to_scipy().tocsr()
    U = ((S + S.T) > 0).astype(np.float32)
    U.setdiag(0)
    U.eliminate_zeros()
    U.sort_indices()
    return CSR.from_scipy(U.tocsr())


def _masked_sum(A, C) -> float:
    """sum of C[i, j] over the nonzero positions (i, j) of A — both CSR with
    sorted columns; vectorized searchsorted join per the CSR row structure."""
    a_iptr = np.asarray(A.indptr, np.int64)
    a_ind = np.asarray(A.indices[: A.nnz], np.int64)
    c_iptr = np.asarray(C.indptr, np.int64)
    c_ind = np.asarray(C.indices[: C.nnz], np.int64)
    c_dat = np.asarray(C.data[: C.nnz])
    # row id per A nonzero, then position of (row, col) inside C's row
    rows = np.repeat(np.arange(A.nrow, dtype=np.int64), np.diff(a_iptr))
    # searchsorted via global keys (rows share no key range after offsetting
    # columns by row * ncol)
    ncol = np.int64(A.shape[1])
    keys_c = np.repeat(np.arange(C.nrow, dtype=np.int64), np.diff(c_iptr)) * ncol + c_ind
    keys_a = rows * ncol + a_ind
    pos = np.searchsorted(keys_c, keys_a)
    hit = (pos < len(keys_c)) & (keys_c[np.minimum(pos, len(keys_c) - 1)] == keys_a)
    return float(c_dat[pos[hit]].sum(dtype=np.float64))


def count_triangles(A, *, device="cuda", stats: dict | None = None) -> float:
    """Triangles in the simple undirected graph with adjacency ``A`` (must be
    symmetric 0/1 with empty diagonal — use :func:`symmetrize`); the product
    runs on ``device`` (``cuda`` unless the caller names ``device="cpu"``;
    raises without a CUDA device).  ``stats``, when given, receives
    ``spgemm_ms`` (the product, its copy to the host included), ``join_ms``
    (the masked sum on the host) and ``out_nnz``."""
    from spmm_tpu_torch import ops

    t0 = time.perf_counter()
    C = ops.spgemm(A, A, device=device).host()  # pattern mode: C[i,j] = #common neighbors
    t1 = time.perf_counter()
    total = _masked_sum(A, C)
    if stats is not None:
        stats.update(spgemm_ms=(t1 - t0) * 1e3, join_ms=(time.perf_counter() - t1) * 1e3, out_nnz=C.nnz)
    return total / 6.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--nnz", type=int, default=600_000)
    ap.add_argument("--check", action="store_true", help="verify vs scipy")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from spmm_tpu_torch.formats.synthetic import webgraph_like

    A = symmetrize(webgraph_like(args.n, args.nnz, seed=0))
    print(f"graph: {A.shape[0]} nodes, {A.nnz // 2} undirected edges")

    t0 = time.perf_counter()
    t = count_triangles(A, device=args.device)
    print(f"triangles: {t:.0f}  ({time.perf_counter() - t0:.2f} s)")

    if args.check:
        S = A.to_scipy()
        ref = (S @ S).multiply(S).sum() / 6.0
        print(f"scipy oracle: {ref:.0f}  match={abs(ref - t) < 0.5}")


if __name__ == "__main__":
    main()
