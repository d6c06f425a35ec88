"""PageRank on a web graph with the PyTorch/CUDA port -- the chained Aᵀx
workload the reference's preprocessing exists for (the counterpart of
examples/pagerank.py, same function and arguments).

The power iteration packs Pᵀ once (``ell_pack``) and chains ``ell_spmv``,
kernel K2 at k = 1, on the card.  The JAX program is one compiled
``lax.scan``; here it is a fixed-length host loop that only enqueues work:
the per-step deltas are written into a device tensor and read once after the
loop, so no iteration waits for the host.

Run:  python examples/pagerank_torch.py [--n 100000] [--nnz 600000] [--iters 50]
      (on an NVIDIA GPU; add --device cpu to run the kernels' plain versions)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pagerank(A, *, damping: float = 0.85, iters: int = 50, tol: float = 1e-8, device="cuda",
             stats: dict | None = None):
    """Power iteration on the Google matrix built from adjacency CSR ``A``
    (rows = source, cols = destination).  Runs the SpMV chain on ``device``
    (``cuda`` unless the caller names ``device="cpu"``; raises without a
    CUDA device) via the ELL slab kernel; returns (ranks, iterations used).
    ``stats``, when given, receives ``loop_ms`` (the ``iters`` steps, host
    clock around a synchronize)."""
    import torch

    from spmm_tpu_torch.formats.containers import compute_device
    from spmm_tpu_torch.formats.ell import ell_pack
    from spmm_tpu_torch.ops.ell_spmm import ell_spmv
    from spmm_tpu_torch.ops.transform import row_sums, scale_rows, transpose

    dev = compute_device(device)
    n = A.shape[0]
    # random-walk matrix P = D^-1 A, dangling rows handled via mass re-injection
    d = row_sums(A)
    dangling = np.asarray(d == 0)
    P = scale_rows(A, np.where(dangling, 0.0, 1.0 / np.maximum(d, 1e-30)))
    # PageRank iterates x <- c P^T x + teleport, so pack P^T once
    Pt = ell_pack(transpose(P)).to(dev)

    x = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    dang = torch.from_numpy(dangling).to(dev)
    deltas = torch.empty(iters, dtype=torch.float32, device=dev)
    _sync(torch, dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(iters):
            spread = ell_spmv(Pt, x)
            lost = torch.where(dang, x, 0.0).sum()  # dangling mass
            x_new = damping * (spread + lost / n) + (1.0 - damping) / n
            deltas[i] = (x_new - x).abs().sum()
            x = x_new
    _sync(torch, dev)
    if stats is not None:
        stats["loop_ms"] = (time.perf_counter() - t0) * 1e3
    deltas = deltas.cpu().numpy()  # the one host read
    converged = np.nonzero(deltas < tol)[0]
    it = int(converged[0]) + 1 if len(converged) else iters
    return x.cpu().numpy(), it


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--nnz", type=int, default=600_000)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--mtx", type=str, default=None, help="optional .mtx input")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    if args.mtx:
        from spmm_tpu_torch import read_mtx, to_csr

        A = to_csr(read_mtx(args.mtx), sort_within_row=True, sum_duplicates=True)
    else:
        from spmm_tpu_torch.formats.synthetic import webgraph_like

        A = webgraph_like(args.n, args.nnz, seed=0)

    t0 = time.perf_counter()
    ranks, used = pagerank(A, iters=args.iters, device=args.device)
    dt = time.perf_counter() - t0
    top = np.argsort(-ranks)[:5]
    print(f"pagerank: n={A.shape[0]} nnz={A.nnz} iters={used} {dt:.2f}s "
          f"({A.nnz * used / dt / 1e6:.1f} M edge-updates/s)")
    print("top pages:", list(zip(top.tolist(), np.round(ranks[top], 6).tolist())))
    assert abs(ranks.sum() - 1.0) < 1e-3


if __name__ == "__main__":
    main()
