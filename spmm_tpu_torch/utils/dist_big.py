"""BASELINE config 5 end to end: the >=100M-nnz row-partitioned SpGEMM,
streamed in pieces over the ranks, exact against scipy (port of
``benchmarks/dist_big_cpu.py``).

``parallel.spgemm_dist_big`` composes the two splits of the big path: A's
rows block-sharded over the ranks, and each rank's rows streamed as
``pieces`` uniform pieces (``ops/slab_spgemm.py: _piece_csr``: the tables,
K4 (b) and K5 on the card), every finished piece gathered to every rank.
PyTorch has no virtual devices, so the ranks are processes (the ``spawn``
method): on the cards (the default) one NCCL rank per card, so one on a
one-card machine; with ``--device cpu`` gloo ranks on the host's CPUs, one
torch thread each, eight by default as the JAX script's virtual mesh.

The matrix is made once in this process (``webgraph_like(n, nnz,
seed)``: pattern values, the reference workload, or seeded normal values
with ``--values``) and sent to every rank.  Rank 0 then checks C against
scipy row block by row block (one block per piece, which keeps the host's
peak at C plus one block of scipy's product): ``nnz``, ``indptr`` (int64)
and ``indices`` equal to scipy's after ``sum_duplicates`` /
``sort_indices``, as the JAX script does; with ``--values`` the structure is
that of the patterns' product (value mode keeps cancelled entries, which
scipy drops) and the values within 1e-4 of max |scipy|.  ``--single`` also
runs ``spgemm_slab_big`` on rank 0's device on the same A, timed, with the
same check.

Prints progress lines, as the JAX script does, then one JSON line: the JAX script's keys
(``n``, ``nnz_in``, ``nnz_out``, ``n_shards``, ``pieces``, ``dist_big_s``,
``mnnz_out_per_s``, ``scipy_s``, ``parity``), then ``gen_s``,
``pieces_chosen``, rank 0's ``sizing_s``, ``stitch_s`` and per piece
``piece_stats`` (``spgemm_dist_big(stats=)``: host sizing ms, the host
clock and CUDA events around ``_piece_csr``, the gather and D2H ms, nnz),
``pieces_computed`` / ``pieces_resumed``, ``slab_big_s``,
``peak_device_gb`` (rank 0; ``single_peak_device_gb`` for
``--single``), ``host_rss_gb`` (the largest process's peak) and
``host_rss_product_gb`` (rank 0's peak when the product returned),
``launches`` (K4 (b) and K5 on every rank, the product only;
``single_launches``), ``kernel_build_s`` (the kernels' build or load
before the product), ``device`` and ``power_limit``.  Exits nonzero on a
mismatch (after the line), a rank that fails or hangs past its deadline,
or any exception (no line then).  No CPU path unless ``--device cpu``.

    python -m spmm_tpu_torch.utils.dist_big [--n 10000000] [--nnz 104600000] [--pieces 4|auto]
        [--seed 5] [--skip-scipy] [--device cuda|cpu] [--ranks N] [--single]
        [--checkpoint-dir DIR] [--values]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import queue
import resource
import sys
import time
from datetime import timedelta

import numpy as np

#: gloo ranks on the host by default, the JAX script's 8-device CPU mesh
CPU_RANKS = 8
#: deadline of the ranks: start, rendezvous, the product and rank 0's checks
RANK_TIMEOUT_S = 3000.0
#: value mode's tolerance, of max |scipy|
VALUE_RTOL = 1e-4
#: the JAX script's keys, first in the line and in its order
JAX_KEYS = ("n", "nnz_in", "nnz_out", "n_shards", "pieces", "dist_big_s", "mnnz_out_per_s", "scipy_s", "parity")


def _log(msg: str) -> None:
    print(msg, flush=True)


def _rss_gb() -> float:
    """This process's peak resident set (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _launches() -> dict:
    from spmm_tpu_torch.ops import slab_kernel

    return {"slab_fetch_merge": slab_kernel.slab_launches["fetch_merge"],
            "slab_compact": slab_kernel.compact_launches}


def _reset_launches() -> None:
    from spmm_tpu_torch.ops import slab_kernel

    for k in slab_kernel.slab_launches:
        slab_kernel.slab_launches[k] = 0
    slab_kernel.compact_launches = 0


def check_blocks(A, results: dict, n_blocks: int, values: bool) -> dict:
    """Each host CSR of ``results`` (name → C) against scipy's A×A, one row
    block of scipy's product at a time: ``{"ref_nnz", "scipy_s",
    "mismatch": {name: first failing block or check}, "max_abs_err",
    "max_abs_ref"}`` (the errors only with ``values``)."""
    t0 = time.perf_counter()
    As = A.to_scipy().tocsr()
    Ps = As
    if values:  # the patterns' product decides the structure (F10)
        Ps = As.copy()
        Ps.data[:] = 1
    t_ref = time.perf_counter() - t0
    n = As.shape[0]
    step = max(-(-n // max(n_blocks, 1)), 1)
    ref_nnz, err, scale = 0, 0.0, 0.0
    bad: dict = {}
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        t0 = time.perf_counter()
        ref = (Ps[r0:r1] @ Ps).tocsr()
        ref.sum_duplicates()
        ref.sort_indices()
        refv = (As[r0:r1] @ As).tocsr() if values else None
        t_ref += time.perf_counter() - t0
        ref_nnz += ref.nnz
        for name, C in results.items():
            if name in bad:
                continue
            iptr = np.asarray(C.indptr, np.int64)
            lo, hi = int(iptr[r0]), int(iptr[r1])
            if not np.array_equal(iptr[r0 : r1 + 1] - lo, ref.indptr.astype(np.int64)):
                bad[name] = f"indptr differs in rows [{r0}, {r1})"
            elif not np.array_equal(np.asarray(C.indices[lo:hi]), ref.indices):
                bad[name] = f"indices differ in rows [{r0}, {r1})"
            elif values:
                import scipy.sparse as sp

                blk = sp.csr_matrix((np.asarray(C.data[lo:hi]), np.asarray(C.indices[lo:hi]),
                                     iptr[r0 : r1 + 1] - lo), shape=ref.shape)
                d = (blk - refv).data
                err = max(err, float(np.abs(d).max(initial=0.0)))
        if values:
            scale = max(scale, float(np.abs(refv.data).max(initial=0.0)))
    for name, C in results.items():
        if name not in bad and int(C.nnz) != ref_nnz:
            bad[name] = f"nnz {int(C.nnz)} against scipy's {ref_nnz}"
        if name not in bad and values and err > VALUE_RTOL * max(scale, 1.0):
            bad[name] = f"values differ by {err:.3e} (tol {VALUE_RTOL:g} of max {scale:.3e})"
    out = {"ref_nnz": ref_nnz, "scipy_s": t_ref, "mismatch": bad}
    if values:
        out.update(max_abs_err=err, max_abs_ref=scale)
    return out


def _rank_main(rank: int, world: int, port: int, A, opts: dict, results) -> None:
    """One rank: join the group (NCCL on card ``rank``, or gloo on one torch
    thread), run ``spgemm_dist_big`` once with its ``stats``; rank 0 then
    leaves the group and runs the checks (and ``--single``).  Puts (rank,
    dict) or (rank, None, traceback) on ``results``."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from spmm_tpu_torch.parallel import make_mesh, spgemm_dist_big
        from spmm_tpu_torch.parallel.mesh import BACKEND_OF

        device_type = opts["device_type"]
        kw, out = {}, {}
        if device_type == "cuda":
            from spmm_tpu_torch import kernels

            dev = torch.device("cuda", rank)
            kw["device_id"] = dev
            torch.cuda.set_device(dev)  # before the communicator
            t0 = time.perf_counter()
            kernels.lib()  # built from the checkout's sources at first use: outside the product's time
            out["build_s"] = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats(dev)
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(1)
        _reset_launches()
        dist.init_process_group(BACKEND_OF[device_type], init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=opts["timeout_s"]), **kw)
        try:
            mesh = make_mesh(device=device_type)
            stats: dict = {}
            dist.barrier()
            t0 = time.perf_counter()
            C = spgemm_dist_big(A, A, mesh, pieces=opts["pieces"], checkpoint_dir=opts["checkpoint_dir"],
                                stats=stats)
            out["dist_big_s"] = time.perf_counter() - t0
            out.update(stats=stats, launches=_launches(), nnz_out=int(C.nnz), rss_product_gb=_rss_gb())
            if device_type == "cuda":
                out["peak_device_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
                out["device"] = torch.cuda.get_device_name(dev)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            Cs = {"dist_big": C}
            if opts["single"]:
                from spmm_tpu_torch.ops.slab_spgemm import spgemm_slab_big

                _reset_launches()
                if device_type == "cuda":
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                Cs["slab_big"] = spgemm_slab_big(A, A, pieces=opts["pieces"], device=dev)
                out["slab_big_s"] = time.perf_counter() - t0
                out["single_launches"] = _launches()
                out["single_nnz_out"] = int(Cs["slab_big"].nnz)
                if device_type == "cuda":
                    out["single_peak_device_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
                _log(f"slab_big: out_nnz={Cs['slab_big'].nnz} on one {device_type} device in "
                     f"{out['slab_big_s']:.1f}s")
            if not opts["skip_scipy"]:
                out["check"] = check_blocks(A, Cs, world * stats["pieces"], opts["values"])
        out["rss_gb"] = _rss_gb()
        results.put((rank, out))
    except Exception:  # reported to the parent, which fails the run
        results.put((rank, None, traceback.format_exc()))


def run_ranks(A, world: int, opts: dict, timeout_s: float = RANK_TIMEOUT_S) -> dict:
    """``world`` spawned ranks run the product (and rank 0 its checks):
    every rank's result dict by rank.  Raises when a rank fails, the ranks
    disagree on C's nnz, or a rank gives no result within ``timeout_s``;
    every rank is ended either way."""
    from spmm_tpu_torch.parallel.mesh import free_port

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    opts = dict(opts, timeout_s=timeout_s)
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, A, opts, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        while len(got) < world:  # drain the queue before any join
            try:
                item = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"{world - len(got)} of {world} ranks gave no result "
                                   f"within {timeout_s:.0f} s") from None
            if item[1] is None:
                raise RuntimeError(f"rank {item[0]} of {world} failed:\n{item[2]}")
            got[item[0]] = item[1]
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    nnzs = {r["nnz_out"] for r in got.values()}
    if len(nnzs) != 1:
        raise RuntimeError(f"the {world} ranks disagree on C's nnz: {sorted(nnzs)}")
    return got


def _pieces_arg(s: str):
    if s == "auto":
        return None
    p = int(s)
    if p < 1:
        raise argparse.ArgumentTypeError("--pieces takes a positive count or 'auto'")
    return p


def _device_type(device: str) -> str:
    """The ranks' device type; ``cuda`` without a card raises at once,
    naming ``--device cpu``."""
    from spmm_tpu_torch.formats.containers import compute_device

    try:
        return compute_device(device).type
    except RuntimeError as e:
        raise RuntimeError(f"{e}; from the command line: --device cpu (gloo ranks on the host)") from None


def run(n: int = 10_000_000, nnz: int = 104_600_000, *, pieces: int | None = 4, seed: int = 5,
        skip_scipy: bool = False, device: str = "cuda", ranks: int | None = None, single: bool = False,
        checkpoint_dir: str | None = None, values: bool = False,
        timeout_s: float = RANK_TIMEOUT_S) -> dict:
    """The whole run: the result line as a dict (its ``parity`` is
    ``"mismatch"`` when a check failed).  Raises as :func:`run_ranks`."""
    import torch

    from spmm_tpu_torch.formats.synthetic import webgraph_like

    device_type = _device_type(device)
    if ranks is None:
        ranks = torch.cuda.device_count() if device_type == "cuda" else CPU_RANKS
    if ranks < 1:
        raise ValueError(f"--ranks {ranks}: a positive count")
    if device_type == "cuda" and ranks > torch.cuda.device_count():
        raise ValueError(f"--ranks {ranks}: NCCL ranks take one card each, and there are "
                         f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    A = webgraph_like(n, nnz, seed=seed)
    if values:
        A.data[:] = np.random.default_rng(seed).standard_normal(A.nnz).astype(A.data.dtype)
    t_gen = time.perf_counter() - t0
    _log(f"generated: n={A.shape[0]} nnz={A.nnz} ({t_gen:.1f}s)")

    opts = dict(device_type=device_type, pieces=pieces, checkpoint_dir=checkpoint_dir, single=single,
                skip_scipy=skip_scipy, values=values)
    got = run_ranks(A, ranks, opts, timeout_s)
    r0 = got[0]
    st = r0["stats"]
    t_mult = max(r["dist_big_s"] for r in got.values())
    nnz_out = r0["nnz_out"]
    _log(f"dist_big: out_nnz={nnz_out} over {ranks} shards x {st['pieces']} pieces in {t_mult:.1f}s")
    res = {
        "n": int(A.shape[0]),
        "nnz_in": int(A.nnz),
        "nnz_out": nnz_out,
        "n_shards": ranks,
        "pieces": "auto" if pieces is None else pieces,
        "dist_big_s": round(t_mult, 3),
        "mnnz_out_per_s": round(nnz_out / t_mult / 1e6, 3),
    }
    ck = r0.get("check")
    if ck is not None:
        res["scipy_s"] = round(ck["scipy_s"], 3)
        res["parity"] = "mismatch" if ck["mismatch"] else "exact"
        res["scipy_nnz"] = ck["ref_nnz"]
        if ck["mismatch"]:
            res["mismatch"] = ck["mismatch"]
        if values:
            res["max_abs_err"], res["max_abs_ref"] = ck["max_abs_err"], ck["max_abs_ref"]
        _log(f"scipy parity {res['parity'].upper()} (nnz/indptr/indices{'/values' if values else ''}) "
             f"in {ck['scipy_s']:.1f}s" + (f": {ck['mismatch']}" if ck["mismatch"] else ""))
    pieces_st = st["piece"]
    res.update(
        gen_s=round(t_gen, 3),
        pieces_chosen=st["pieces"],
        sizing_s=round(st["sizing_ms"] / 1e3, 3),
        stitch_s=round(st["stitch_ms"] / 1e3, 3),
        piece_stats=[{k: (round(v, 3) if isinstance(v, float) else v) for k, v in p.items()} for p in pieces_st],
        pieces_computed=sum(not p["resumed"] for p in pieces_st),
        pieces_resumed=sum(p["resumed"] for p in pieces_st),
    )
    if single:
        res["slab_big_s"] = round(r0["slab_big_s"], 3)
        res["single_nnz_out"] = r0["single_nnz_out"]
    if device_type == "cuda":
        res["peak_device_gb"] = round(max(r["peak_device_gb"] for r in got.values()), 3)
        if single:
            res["single_peak_device_gb"] = round(r0["single_peak_device_gb"], 3)
    res["host_rss_gb"] = round(max([_rss_gb()] + [r["rss_gb"] for r in got.values()]), 3)
    res["host_rss_product_gb"] = round(r0["rss_product_gb"], 3)
    res["launches"] = {k: sum(r["launches"][k] for r in got.values()) for k in r0["launches"]}
    if single:
        res["single_launches"] = r0["single_launches"]
    if device_type == "cuda":
        res["kernel_build_s"] = round(max(r["build_s"] for r in got.values()), 3)
    res["device"] = r0.get("device", "cpu")
    if device_type == "cuda":
        from spmm_tpu_torch.utils.primitives import power_limit

        res["power_limit"] = power_limit(torch.device("cuda", 0))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--nnz", type=int, default=104_600_000)
    ap.add_argument("--pieces", type=_pieces_arg, default=4,
                    help="pieces per rank, or 'auto' (the smallest power of two whose pieces fit the slab budget)")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--skip-scipy", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: NCCL ranks, one card each; fails without a card) or cpu "
                         "(gloo ranks on the host)")
    ap.add_argument("--ranks", type=int, default=None,
                    help=f"ranks (default: every card on cuda, {CPU_RANKS} on cpu)")
    ap.add_argument("--single", action="store_true",
                    help="also run spgemm_slab_big on rank 0's device, timed and checked the same way")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="persist each finished piece there and resume from it (one directory every rank sees)")
    ap.add_argument("--values", action="store_true",
                    help="seeded normal values in place of the pattern (checked within 1e-4 of max |scipy|)")
    args = ap.parse_args(argv)
    try:
        _device_type(args.device)
    except RuntimeError as e:
        print(f"dist_big: {e}", file=sys.stderr, flush=True)
        return 2
    res = run(args.n, args.nnz, pieces=args.pieces, seed=args.seed, skip_scipy=args.skip_scipy,
              device=args.device, ranks=args.ranks, single=args.single, checkpoint_dir=args.checkpoint_dir,
              values=args.values)
    print(json.dumps(res), flush=True)
    return 1 if res.get("parity") == "mismatch" else 0


if __name__ == "__main__":
    sys.exit(main())
