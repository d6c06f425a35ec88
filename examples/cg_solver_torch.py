"""Conjugate gradients on a graph Laplacian with the PyTorch/CUDA port --
iterative solves over SpMV (the counterpart of examples/cg_solver.py, same
functions and arguments).

Solve ``(L + eps I) x = b`` for the Laplacian of a web graph.  The CG loop
packs L once and chains ``ell_spmv`` (kernel K2 at k = 1) on the card.  The
JAX program is one compiled ``lax.scan``; here it is a fixed-length host loop
that only enqueues work: every scalar of the recurrence (alpha, beta, the
residual norms) stays a 0-d device tensor, the guards are ``torch.where``,
and the residual history is read once after the loop.

Run: python examples/cg_solver_torch.py [--n 50000] [--nnz 300000] [--iters 200]
     (on an NVIDIA GPU; add --device cpu to run the kernels' plain versions)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def laplacian_system(A, eps: float = 1e-2):
    """Symmetrize A, build L = D - (A_s) + eps*I as CSR (SPD)."""
    import scipy.sparse as sp

    from spmm_tpu_torch.formats.containers import CSR
    from spmm_tpu_torch.ops.transform import add, row_sums, transpose

    S = add(A, transpose(A), alpha=0.5, beta=0.5)  # symmetric part
    d = row_sums(S)
    D = CSR.from_scipy(sp.diags(np.asarray(d) + eps).tocsr())
    return add(D, S, alpha=1.0, beta=-1.0)


def cg(L, b, *, iters: int = 200, tol: float = 1e-8, device="cuda", stats: dict | None = None):
    """Plain CG on ``device`` (``cuda`` unless the caller names
    ``device="cpu"``; raises without a CUDA device); returns (x,
    residual_history).  ``stats``, when given, receives ``loop_ms``."""
    import torch

    from spmm_tpu_torch.formats.containers import compute_device
    from spmm_tpu_torch.formats.ell import ell_pack
    from spmm_tpu_torch.ops.ell_spmm import ell_spmv

    dev = compute_device(device)
    E = ell_pack(L).to(dev)
    b = torch.from_numpy(np.asarray(b, np.float32)).to(dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.dot(r, r)
    hist = torch.empty(iters, dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(iters):
            Ap = ell_spmv(E, p)
            denom = torch.dot(p, Ap)
            alpha = torch.where(denom > 0, rs / denom, zero)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = torch.dot(r, r)
            beta = torch.where(rs > 0, rs_new / rs, zero)
            p = r + beta * p
            rs = rs_new
            hist[i] = torch.sqrt(rs_new)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if stats is not None:
        stats["loop_ms"] = (time.perf_counter() - t0) * 1e3
    hist = hist.cpu().numpy()  # the one host read
    conv = np.nonzero(hist < tol * hist[0])[0]
    used = int(conv[0]) + 1 if len(conv) else iters
    return x.cpu().numpy(), hist[:used]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--nnz", type=int, default=300_000)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from spmm_tpu_torch.formats.synthetic import webgraph_like

    A = webgraph_like(args.n, args.nnz, seed=0)
    L = laplacian_system(A)
    b = np.random.default_rng(0).standard_normal(args.n).astype(np.float32)

    t0 = time.perf_counter()
    x, hist = cg(L, b, iters=args.iters, device=args.device)
    dt = time.perf_counter() - t0
    # residual check on host
    res = np.linalg.norm(L.to_scipy() @ x - b) / np.linalg.norm(b)
    print(f"cg: n={args.n} nnz(L)={L.nnz} iters={len(hist)} {dt:.2f}s "
          f"relative residual {res:.2e}")


if __name__ == "__main__":
    main()
