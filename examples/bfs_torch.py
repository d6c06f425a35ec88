"""Breadth-first search by frontier SpMV with the PyTorch/CUDA port --
level-synchronous graph traversal (the counterpart of examples/bfs.py, same
function and arguments).

BFS distance labeling is repeated sparse matrix-vector products over the
boolean semiring: each level is one ELL SpMV on the transposed adjacency
(kernel K2 at k = 1, frontier push), a visited-mask update and a distance
write, all on the card.  The JAX program is one ``lax.while_loop`` that
exits on the device; PyTorch has no device-side loop, so this one reads ONE
scalar per level -- whether the new frontier is empty -- and nothing else
crosses to the host until the distances are returned.

Semiring note: over floats, ``(A^T f) > 0`` is exactly the boolean
or-and product for a 0/1 pattern matrix.

Run:  python examples/bfs_torch.py [--n 100000] [--nnz 600000] [--source 0]
      (on an NVIDIA GPU; add --device cpu to run the kernels' plain versions)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bfs(A, source: int, *, max_levels: int | None = None, device="cuda",
        stats: dict | None = None):
    """Level-synchronous BFS from ``source`` over the directed graph with
    adjacency CSR ``A`` (rows = src, cols = dst; values ignored, pattern
    semantics), on ``device`` (``cuda`` unless the caller names
    ``device="cpu"``; raises without a CUDA device).  Returns int32
    distances, -1 for unreachable, and the eccentricity of ``source``.
    ``stats``, when given, receives ``loop_ms`` and ``levels`` (loop trips)."""
    import torch

    from spmm_tpu_torch.formats.containers import compute_device
    from spmm_tpu_torch.formats.ell import ell_pack
    from spmm_tpu_torch.ops.ell_spmm import ell_spmv
    from spmm_tpu_torch.ops.transform import transpose

    dev = compute_device(device)
    n = A.shape[0]
    At = transpose(A)
    # binarize so "values ignored" is actually true: with raw values,
    # negative or cancelling edge weights could sum to <= 0 and drop
    # frontier nodes from the `pushed > 0` test (padding stays zero)
    bdata = (np.asarray(At.data) != 0).astype(np.float32)
    At = type(At)(bdata, At.indices, At.indptr, At.shape, At.nnz)
    Et = ell_pack(At).to(dev)
    max_levels = n if max_levels is None else max_levels

    dist = torch.full((n,), -1, dtype=torch.int32, device=dev)
    dist[source] = 0
    frontier = torch.zeros(n, dtype=torch.float32, device=dev)
    frontier[source] = 1.0
    level = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        # the one host read per level: is there a frontier left
        while level < max_levels and bool(frontier.sum() > 0):
            # next frontier: any in-neighbor in the current frontier, not seen
            pushed = ell_spmv(Et, frontier) > 0
            fresh = pushed & (dist < 0)
            dist = torch.where(fresh, level + 1, dist)
            frontier = fresh.to(torch.float32)
            level += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if stats is not None:
        stats["loop_ms"] = (time.perf_counter() - t0) * 1e3
        stats["levels"] = level
    # the loop runs one final iteration that discovers nothing; level - 1 is
    # the eccentricity of ``source`` (the largest finite distance)
    return dist.cpu().numpy(), max(level - 1, 0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--nnz", type=int, default=600_000)
    ap.add_argument("--source", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from spmm_tpu_torch.formats.synthetic import webgraph_like

    A = webgraph_like(args.n, args.nnz, seed=0)
    t0 = time.perf_counter()
    dist, levels = bfs(A, args.source, device=args.device)
    dt = time.perf_counter() - t0
    reached = int((dist >= 0).sum())
    print(
        f"bfs: n={args.n} nnz={A.nnz} source={args.source}: "
        f"{reached} reached in {levels} levels, "
        f"{dt*1e3:.1f} ms (incl. the pack)"
    )


if __name__ == "__main__":
    main()
