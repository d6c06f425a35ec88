"""The executed SPMD SpGEMM scaling curve (port of
``benchmarks/scaling_cpu.py``).

The shard balance (``bench_torch.py``'s ``spgemm_shard_balance_8``) is a
projection made on the host; this runs the SPMD SpGEMM program
(``parallel.spgemm_dist_spmd``) at 1, 2, 4 and 8 ranks on the same matrix
and reports the wall time per rank count.  PyTorch has no virtual devices,
so the ranks are processes (the ``spawn`` method).  On the cards (the
default) each rank is one NCCL rank on a card of its own, so the counts
above the number of cards are not run (``scaling_truncated_at`` names the
first); ``device="cpu"`` asks for gloo ranks on the host's CPUs, one torch
thread each, which is what the JAX script's virtual CPU devices measured:
the program's overhead on a host mesh, no device number.

``spgemm_scaling_<device>_N`` is the slowest rank's time per call at N
ranks (``spgemm_scaling_cpu_N`` as the JAX script names it);
``spgemm_overhead_flatness_N`` is t(1) / t(N): the same total work spread
over N ranks.  Every count must give scipy's nnz of A×A.  A rank that hangs
fails the run within its deadline (``init_process_group``'s timeout, and
the parent's wait for each result) instead of hanging the caller.

Prints one JSON line:

    python -m spmm_tpu_torch.utils.scaling [--n 60000] [--nnz 360000] [--iters 2] [--budget 330]
                                           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import queue
import time
from datetime import timedelta

#: coarse classes, as the JAX script's: the curve compares rank counts, so
#: one (coarse) configuration at every count is what matters
CLASSES = (16, 64, 256, 1024, 4096, 16384)
RANK_COUNTS = (1, 2, 4, 8)
#: deadline of one rank count: its ranks' start, rendezvous and every call
COUNT_TIMEOUT_S = 240.0


def _rank_main(rank: int, world: int, port: int, A, iters: int, timeout_s: float, device_type: str,
               results) -> None:
    """One rank: join the group (NCCL on card ``rank``, or gloo on one
    torch thread), one first call, then ``iters`` timed calls, each started
    together behind a barrier and ended by a synchronisation of the card.
    Puts (rank, nnz, ms list) or (rank, None, traceback) on ``results``."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from spmm_tpu_torch.parallel import make_mesh, partition_rows, spgemm_dist_spmd
        from spmm_tpu_torch.parallel.mesh import BACKEND_OF

        kw = {}
        if device_type == "cuda":
            kw["device_id"] = torch.device("cuda", rank)
            torch.cuda.set_device(kw["device_id"])  # before the communicator
        else:
            torch.set_num_threads(1)
        dist.init_process_group(BACKEND_OF[device_type], init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout_s), **kw)
        try:
            mesh = make_mesh(device=device_type)
            S = partition_rows(A, world)
            C = spgemm_dist_spmd(S, A, mesh, classes=CLASSES)
            times = []
            for _ in range(iters):
                dist.barrier()
                t0 = time.perf_counter()
                spgemm_dist_spmd(S, A, mesh, classes=CLASSES)
                if device_type == "cuda":
                    torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            results.put((rank, int(C.nnz), times))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which fails the run
        results.put((rank, None, traceback.format_exc()))


def run_count(A, world: int, iters: int, timeout_s: float = COUNT_TIMEOUT_S, device_type: str = "cuda"):
    """``world`` spawned ranks (NCCL, one card each, or gloo for
    ``device_type="cpu"``) run the program on A: (C's nnz, ms per
    call of the slowest rank, the best of ``iters``).  Raises when a rank
    fails, disagrees on C's nnz, or gives no result within ``timeout_s``;
    every rank is ended either way."""
    from spmm_tpu_torch.parallel.mesh import free_port

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, A, iters, timeout_s, device_type, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        while len(got) < world:  # drain the queue before any join
            try:
                rank, nnz, out = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"{world - len(got)} of {world} ranks gave no result "
                                   f"within {timeout_s:.0f} s") from None
            if nnz is None:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = (nnz, out)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    nnzs = {nnz for nnz, _ in got.values()}
    if len(nnzs) != 1:
        raise RuntimeError(f"the {world} ranks disagree on C's nnz: {sorted(nnzs)}")
    per_call = [max(got[r][1][i] for r in got) for i in range(iters)]
    return nnzs.pop(), min(per_call)


def scaling_curve(n: int = 60_000, nnz: int = 360_000, *, iters: int = 2, budget_s: float = 330.0,
                  rank_counts=RANK_COUNTS, seed: int = 0, timeout_s: float = COUNT_TIMEOUT_S,
                  device="cuda") -> dict:
    """The curve as ``bench_torch.py`` reports it: ``scaling_n``,
    ``scaling_nnz``, ``scaling_out_nnz`` (scipy's nnz of A×A, which every
    count gave), ``spgemm_scaling_<device>_N`` (ms) and
    ``spgemm_overhead_flatness_N`` per rank count N, and
    ``scaling_truncated_at``, the first count skipped: once ``budget_s`` has
    passed, or on the cards the first count above their number.  The first
    count always runs: every other is read against it.  On the cards unless
    ``device="cpu"`` asks for gloo ranks on the host (raises without a card,
    before any rank starts).  Raises when a count's nnz differs from scipy's
    A×A."""
    import torch

    from spmm_tpu_torch.formats.containers import compute_device
    from spmm_tpu_torch.formats.synthetic import webgraph_like

    t_start = time.monotonic()
    device_type = compute_device(device).type
    cards = torch.cuda.device_count() if device_type == "cuda" else None
    A = webgraph_like(n, nnz, seed=seed)
    As = A.to_scipy()
    ref_nnz = int((As @ As).nnz)
    out = {"scaling_n": int(n), "scaling_nnz": int(A.nnz), "scaling_out_nnz": ref_nnz}
    t1 = None
    for i, world in enumerate(rank_counts):
        if (i and time.monotonic() - t_start > budget_s) or (cards is not None and world > cards):
            out["scaling_truncated_at"] = int(world)
            break
        c_nnz, ms = run_count(A, world, iters, timeout_s, device_type)
        if c_nnz != ref_nnz:
            raise RuntimeError(f"{world} ranks: C has {c_nnz} nonzeros, scipy's A×A {ref_nnz}")
        t1 = ms if t1 is None else t1
        out[f"spgemm_scaling_{device_type}_{world}"] = round(ms, 1)
        out[f"spgemm_overhead_flatness_{world}"] = round(t1 / ms, 3)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=60_000)
    ap.add_argument("--nnz", type=int, default=360_000)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--budget", type=float, default=330.0,
                    help="soft wall-time budget (s): the rank counts after it are skipped, "
                    "the partial curve is still printed")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: NCCL ranks, one card each; raises without a card) "
                    "or cpu (gloo ranks on the host)")
    args = ap.parse_args(argv)
    print(json.dumps(scaling_curve(args.n, args.nnz, iters=args.iters, budget_s=args.budget,
                                   device=args.device)), flush=True)


if __name__ == "__main__":
    main()
