#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``spmm_tpu_torch``) once on one NVIDIA GPU.

Phases, each printing one line with its times (CUDA events for kernels,
``torch.cuda.synchronize()`` around ``perf_counter`` for host phases):

1. device   — require CUDA; print ``nvidia-smi`` name and power limit.
2. build    — build the CUDA kernels (nvcc) and the native host library (g++)
              from this checkout's sources; print the nvcc version.
3. kernels  — each hand-written kernel against its plain PyTorch version on
              the card: K1 (BSR) through ``ops.spmm(BSR, B)`` on
              ``banded_random(65536, 512, 0.25, seed=3)`` at k=128 in fp32,
              bf16 and fp64, and its transposed kernel (the gradient with
              respect to B, A's blocks read in place), beside the
              ``torch.bmm`` value gradient; K2 over all 78 slabs of the ELL
              pack of ``webgraph_like(916_428, 5_105_039, seed=0)``
              (web-Google size) in one launch at k=128 and k=32, in fp64 at
              k=128, and over the transposed pack with ``ell_spmm``'s row
              map and the value index (grad B); K3 (the slab values'
              gradient) at k=128 and k=32; the ordered segment sum on
              PageRank's leftover rows (Pᵀ's 75 hub rows at k=1) and on
              ``blocked_spmm_slab``'s leftover stream at k=128, beside the
              atomic ``index_add_`` it replaced and ``torch.segment_reduce``
              (its bits over three runs printed); K4 (a, b, c) and K5, the
              slab SpGEMM's numeric phase, over every chunk of the
              web-Google A×A in value mode (fp32) and pattern mode, each
              against its plain version.  Per kernel and shape:
              max error, kernel / plain / library ms (CUDA events, mean of
              10; the package's ``utils.timing.measure``; for K3 and the
              ordered sum, whose back-to-back calls the host's enqueue can
              outlast, the kernels line's ``ms`` is the profiler's device
              time per call, with the events' time and the host's enqueue
              per call beside it), the bound computed
              from these matrices (``ops.roofline``: bytes at 3.35 TB/s or
              operations at the type's peak, whichever is larger; for K1
              fp32 also the fp32-FMA and the 3xTF32 tensor-core bounds), the
              share of it reached, and the time before the kernel's redesign
              (from PERF.md, printed only; for the two grad-B routes the
              routes they replaced: a re-blocked Aᵀ with a value gather, and
              the value and row gathers around K2).
4. main     — the port's main path with every launch counter at 0: the CLI
              (.mtx ingest → preprocess → ELL SpMM k=128 → exact A×A through
              the slab SpGEMM, --check against scipy) on the web-Google-sized
              graph, then the SpMM dispatcher on the BSR and CSR forms.
              Requires exact C structure, SpMM within tolerance, and every
              kernel launched.
5. slab     — the slab SpGEMM's entry points on the same graph, each product
              held against one scipy A×A: the plan (with its aligned cache,
              one K4 (a) launch), ``spgemm_plan_revalue`` of it with seeded
              normal values (one K4 (a) launch; its product within 1e-4 of
              max), its numeric phase and the chain of 8 (CUDA events), the device
              CSR, ``ops.spgemm`` three times (cold, plan build, plan reuse),
              a value-mode product, the global-sort ``spgemm_sorted``, the
              4-piece big path with a checkpoint and its resume (0 pieces
              recomputed), peak device memory, a profiler breakdown of the
              warm numeric phase by op, the torch stages S2 / S1 / S3 beside
              K4 (b), K4 (c) and K5, and the launch counters showing that the
              entry points reached every K4 entry and K5.
6. blocked  — slice 3 on the same graph, with the launch counters at 0 again:
              ``preprocess`` → the slab views → ``blocked_spmm_slab`` at k=128
              (one K2 launch over all v8-group buckets; against its plain
              version and scipy), the other BlockedCSR formulations, the 3-step
              ``blocked_chain_spmv``, SpGEMM → SpMM on the device CSR (packed
              by ``ell_pack_device``, one K2 launch), ``bitmap_perm_device``
              (equal to the host permutation), ``bsr_spmv``, ``sddmm`` and
              ``entry()``; then each timed (CUDA events) beside ``ell_spmm``.
7. grad     — this slice's path, with the launch counters at 0 again: (a)
              ``sum(spmm(A, B)**2)`` forward and ``backward()`` at full size
              and k=128 through ``ell_spmm`` (B and the slab values),
              ``blocked_spmm_slab`` and ``ops.spmm(BSR)``: gradients against
              scipy's ``2 Aᵀ(A B)`` and the plain versions' autograd
              gradient, the slab values' against ``2 Y[row]·B[col]``,
              bit-identical repeats, the launch counts (one K2 forward, one
              K2 on the transposed pack, one K3), forward + backward ms and a
              profile; (b) fp64 ``ell_spmm`` and a value-mode
              ``ops.spgemm(accum_dtype=float64)`` against scipy; (c) the four
              ``examples/*_torch.py`` programs through their functions:
              PageRank (50 iterations), CG (200, run twice: the two residual
              histories must be equal in their bits) and BFS at web-Google
              size, triangle counting at ``TRI_N`` = 49,152 nodes (the
              symmetrised web-Google graph's hubs make its A×A 1.8e11
              partial products).
8. dist     — the distribution layer (``spmm_tpu_torch.parallel``), with the
              launch counters at 0 again: (a) NCCL at world size 1 on the
              card (one card; NCCL takes no two ranks on one GPU):
              ``partition_rows`` / ``partition_cols`` of the web-Google-sized
              graph, ``spmm_dist``, ``spmm_dist_ring``, ``spmm_dist_colsplit``
              at k=128 and ``spmv_dist``, each held against scipy (1e-4 of
              max) and the single-chip ``ops.spmm`` / ``ops.spmv`` (1e-5),
              one K2 launch each, timed beside that call (CUDA events); then
              ``spgemm_dist_spmd`` and ``spgemm_dist_csr`` on A×A, structure
              equal to scipy's, timed beside ``ops.spgemm`` (without a plan)
              and ``spgemm_slab_csr``; then ``spgemm_dist_halo``,
              ``spgemm_dist_halo_exchange``, ``spgemm_dist_plan`` / ``exec``
              (B replicated and ``b_sharded``; one K4 (a) launch per plan),
              ``spgemm_dist_revalue`` of the all-ones plans to seeded normal
              values (F1; one K4 (a) launch each) and
              ``spgemm_dist_big(pieces=2)`` in both B modes, each exact
              against scipy (the revalue within 1e-4 of max) with its
              ``all_to_all_single`` calls counted, timed beside
              ``spgemm_dist_spmd``, ``ops.spgemm``'s plan reuse and
              ``spgemm_slab_big(pieces=2)``; last ``dryrun_multichip(1)``
              with its K2 launches.  (b) four gloo ranks on the host's
              CPUs (the tests' rank pool, ``tests/torch_dist.py``) run every
              entry point on ``webgraph_like(65_536, 365_000, seed=0)`` at
              k=32 against scipy, then ``dryrun_multichip(4)`` on a (2, 2)
              mesh: the collective logic under this machine's torch, a host
              run of the plain versions.
9. rates    — the committed primitive rates
              (``spmm_tpu_torch/primitive_rates_h100.json``; its ``_device``
              must be this card) beside the probe
              (``utils.primitives.measure_rates``) run again at 2^22 elements
              (printed only: rates move by some percent between cards), and
              the attainable share (``ops.roofline.*_attainable`` / measured
              time) of ``ell_spmm`` k=128 and K2 on the web-Google pack,
              ``ell_spmv`` on it (timed here), ``ops.spgemm`` cold, the warm
              numeric phase and the chain per product (phase 5's times),
              each finite and above 0, by the file's rates and by this
              run's.
10. bench   — ``python bench_torch.py --quick --no-scaling`` (the port's
              one-JSON-line benchmark) in a subprocess with
              ``BENCH_BUDGET_S=400``: exit 0, its last line JSON with
              ``value`` > 0, no ``*_error`` / ``interrupted`` / ``skipped``,
              every ``*_ms`` finite and > 0, every ``*_sol_frac`` in
              (0, 1.05], every ``*_att_frac`` finite and > 0,
              ``spgemm_out_nnz`` equal to scipy's A×A on the quick graph and
              ``device`` this card; its main numbers and each section's
              seconds printed.
11. report  — one JSON line of per-kernel results (launches of phases 4, 6, 7
              and 8a -- K4 and K5 are required on phases 4, 5 and 8a --, the
              entry points that launched each kernel, phase 3's
              times, bound and library time at the main-path shape; K2 also
              its roofline share and its attainable share by this run's
              probe), the card's name and power
              limit, and the final ``{"ok": true, ...}`` line.

Any failure stops the run with a nonzero exit and no result line.  There is
no CPU path: without CUDA, or without the rest of the repository beside this
file, it exits nonzero.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

#: fp32 kernels hold their plain versions to this max relative error (sums in
#: another order); bf16 inputs, widened to fp32 in both, to the bf16 bound
RTOL_F32 = 1e-5
RTOL_BF16 = 2e-2
WEB_N, WEB_NNZ = 916_428, 5_105_039  # web-Google size (bench.py:44-45)
#: fp64 kernels hold their plain versions to this
RTOL_F64 = 1e-12
#: nodes of the triangle-counting graph (phase 7c says why not web-Google's)
TRI_N = 49_152
#: each kernel's time at the phase 3 shapes before its redesign for Hopper,
#: printed beside the new one (PERF.md's kernel table; not a measurement of
#: this run, so not in the kernels line)
PRIOR_MS = {"K2 k=128": 2.8529, "K2 k=32": 2.6395, "K1 fp32": 0.8087,
            "K1 on Aᵀ": "0.7702 / 0.7821", "K2 on Aᵀ": "1.5371-1.5782", "K2 on Aᵀ k=32": "0.9919-1.0138",
            "K3 k=128": "0.7775 / 0.8962", "K3 k=32": "not measured",
            "ordered sum Pᵀ": "0.0688 / 0.0826", "ordered sum k=128 stream": "0.21 (profile)",
            "slab_fetch_merge": "1.9415 / 1.6763", "slab_merge": "1.8336 / 1.7842",
            "slab_compact": "1.5029 / 1.0814", "slab_fetch": "1.5911 / 1.3133"}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(line: str) -> None:
    print(line, flush=True)


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (warm L2):
    CUDA events through the package's ``measure``."""
    from spmm_tpu_torch.utils.timing import measure

    return measure(fn, warmup=warmup, iters=iters, cuda=True).mean_ms


def host_timed(torch, fn):
    """``(fn(), ms)`` on the host clock around work that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_errs(y, ref):
    err = float((y - ref).abs().max()) if y.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    return err, err / max(scale, 1e-30)


def scipy_square(S):
    ref = (S @ S).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    return ref


def held_against(C, ref, what: str, rtol=None) -> float:
    """Fails unless C's structure equals scipy's and its values are exact
    (pattern counts) or, with ``rtol``, within rtol * max |scipy|.  Returns
    the max abs error."""
    h = C.host()
    dat = np.asarray(h.data[: C.nnz])
    require(C.nnz == ref.nnz and np.array_equal(np.asarray(h.indptr, np.int64), ref.indptr)
            and np.array_equal(np.asarray(h.indices[: C.nnz]), ref.indices),
            f"{what}: structure differs from scipy's ({C.nnz} vs {ref.nnz} nnz)")
    err = float(np.abs(dat - ref.data).max()) if ref.nnz else 0.0
    if rtol is None:
        require(err == 0.0, f"{what}: counts differ from scipy's (max err {err})")
    else:
        require(err <= rtol * float(np.abs(ref.data).max()), f"{what}: max err {err:.3e}")
    return err


#: the slab SpGEMM's kernels, by their names in the report: K4 (a) the
#: chunk fetch, (b) fetch + merge, (c) the merge of a cached slab; K5
SPGEMM_KERNELS = ("slab_fetch", "slab_fetch_merge", "slab_merge", "slab_compact")


def counters() -> dict:
    """Every launch counter of the port, by the name it has in the report."""
    from spmm_tpu_torch.ops import bsr_kernel, ell_kernel, segments, slab_kernel

    entry = slab_kernel.slab_launches
    return {"ell_slab_spmm": ell_kernel.launches, "bsr_spmm": bsr_kernel.launches,
            "ell_slab_spmm_transposed": ell_kernel.transposed_launches,
            "ell_slab_sddmm": ell_kernel.sddmm_launches,
            "bsr_spmm_transposed": bsr_kernel.transposed_launches,
            "segment_sum": segments.launches,
            "slab_fetch": entry["fetch"], "slab_fetch_merge": entry["fetch_merge"], "slab_merge": entry["merge"],
            "slab_compact": slab_kernel.compact_launches}


def reset_counters() -> None:
    from spmm_tpu_torch.ops import bsr_kernel, ell_kernel, segments, slab_kernel

    ell_kernel.launches = ell_kernel.transposed_launches = ell_kernel.sddmm_launches = 0
    bsr_kernel.launches = bsr_kernel.transposed_launches = 0
    segments.launches = 0
    slab_kernel.compact_launches = 0
    slab_kernel.slab_launches.update(dict.fromkeys(slab_kernel.slab_launches, 0))


def traced(paths: dict, name: str, fn, tally: dict | None = None):
    """Run ``fn`` and add ``name`` to the paths of every kernel it launched;
    ``tally``, when given, gains the launches of this one call (a phase that
    also times its path keeps the timing repeats out of its count so)."""
    before = counters()
    out = fn()
    for k, n in counters().items():
        if n > before[k] and name not in paths[k]:
            paths[k].append(name)
        if tally is not None:
            tally[k] = tally.get(k, 0) + n - before[k]
    return out


def launched(paths: dict, name: str, fn, want: dict, tally: dict | None = None):
    """``traced``, and fails unless ``fn`` launched each kernel in ``want``
    exactly that many times (one K2 launch per product)."""
    before = counters()
    out = traced(paths, name, fn, tally)
    after = counters()
    for k, n in want.items():
        got = after[k] - before[k]
        require(got == n, f"{name}: {got} {k} launches, expected {n}")
    return out


def device_and_enqueue(torch, fn, repeats: int = 10):
    """``(device ms, host µs)`` per call of ``fn``: the sum of its kernels'
    device times under ``torch.profiler`` (``utils.profiling.profile_fn``),
    and the host's time to enqueue one call, over ``repeats`` calls made
    back to back with no synchronize.  Back-to-back CUDA events stop
    measuring a kernel of a few µs once the host's enqueue is slower."""
    from spmm_tpu_torch.utils.profiling import profile_fn

    prof = profile_fn(fn, repeats=repeats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    enq = (time.perf_counter() - t0) / repeats * 1e6
    torch.cuda.synchronize()
    return prof.total_device_ms, enq


def ordered_sum_shape(torch, segments, contrib, plan, ids, bound, peak, what: str, prior) -> dict:
    """The ordered sum on one shape against its plain version taken in fp64
    (rel 1e-5 of max; the fp32 plain version's distance printed beside),
    three runs equal in their bits; its CUDA-event time beside the
    profiler's device time and the host's enqueue per call, the plain
    version's and ``index_add_``'s (the atomic scatter it replaced), the
    bound (each input once, the output once).  Prints one line; returns the
    kernels line's entry."""
    nseg, k = plan.num_segments, contrib.shape[1]
    empty = int((plan.offsets[1:] == plan.offsets[:-1]).sum())
    run = lambda: segments.segment_sum(contrib, plan=plan)
    lib_run = lambda: torch.zeros((nseg, k), device=contrib.device).index_add_(0, ids, contrib[: ids.numel()])
    runs = [run() for _ in range(3)]
    ref = segments.segment_sum_reference(contrib, plan)
    red_runs = [ref] + [segments.segment_sum_reference(contrib, plan) for _ in range(2)]
    lib_runs = [lib_run() for _ in range(3)]
    exact = segments.segment_sum_reference(contrib.double(), plan)  # the plain version in fp64
    torch.cuda.synchronize()
    same = lambda rs: all(torch.equal(rs[0], r) for r in rs[1:])
    require(same(runs), f"the ordered sum {what}: three runs differ in their bits")
    # held to the plain version in fp64: in fp32, torch.segment_reduce adds a
    # hub's 345,617 rows one by one and its own rounding reaches ~1e-5 of max
    err, rel = max_errs(runs[0].double(), exact)
    require(rel <= RTOL_F32, f"the ordered-sum kernel {what} differs from its plain version in fp64: rel {rel:.3e}")
    _, rel_ref = max_errs(runs[0], ref)
    _, rel_ref_exact = max_errs(ref.double(), exact)
    red_same, lib_same = same(red_runs), same(lib_runs)
    del runs, red_runs, lib_runs, exact
    ms = cuda_ms(torch, run)
    dev_ms, enq = device_and_enqueue(torch, run)
    plain = cuda_ms(torch, lambda: segments.segment_sum_reference(contrib, plan))
    lib = cuda_ms(torch, lib_run)
    nbytes = contrib.numel() * 4 + plan.offsets.numel() * 8 + nseg * k * 4
    if plan.order is not None:
        nbytes += plan.order.numel() * 8
    b = bound(nbytes, contrib.numel(), peak)
    say(f"phase 3 ordered segment sum {what}, {empty} of its {nseg} segments empty: max_abs_err {err:.3e} "
        f"max_rel_err {rel:.3e} against the plain "
        f"version in fp64 (tol {RTOL_F32:g}; the fp32 plain version is {rel_ref_exact:.3e} from it and "
        f"{rel_ref:.3e} from the kernel), three runs bit-identical | kernel {ms:.4f} ms by CUDA events (profiler: device {dev_ms:.4f} ms per "
        f"call, host enqueue {enq:.1f} us per call) | plain (torch.segment_reduce) {plain:.4f} ms, three runs "
        f"{'bit-identical' if red_same else 'DIFFER in their bits'} | bound {b[0]:.4f} ms ({b[1]}; "
        f"{nbytes / 1e6:.1f} MB), share of the device time {b[0] / dev_ms:.1%} | library index_add_ (atomic) "
        f"{lib:.4f} ms, three runs {'bit-identical' if lib_same else 'differ in their bits'} | before "
        f"the redesign {prior} ms (PERF.md)")
    return dict(max_abs_err=err, max_rel_err=rel, max_rel_err_vs_fp32_plain=rel_ref, ms=dev_ms, plain_ms=plain,
                bound_ms=b[0], bound_by=b[1], library_ms=lib,
                library="Tensor.index_add_ (the atomic scatter it replaces)", event_ms=ms, enqueue_us=enq)


def slab_kernel_rows(torch, A, dev, rng, bound, peak) -> dict:
    """Phase 3's K4 and K5 rows: every chunk of the web-Google A×A in value
    mode (seeded normal values, fp32) and in pattern mode, each entry
    against its plain version on the same inputs -- K4 (a) bit-equal to
    ``_chunk_fetch``, (b) and (c) equal to ``_merge_block`` in columns and
    nuniq on the live slots, values within 1e-5 of max of the fp64 plain
    merge (2e-5 of the fp32 one; pattern counts exact), (b) over the
    product, (b) chunk by chunk and (c) on the slabs (a) built
    bit-identical, K5 equal to ``_compact_to_csr`` and its CSR to scipy's
    -- then each timed over the whole product (CUDA events: (b) and (c) one
    launch per block-size group, (a) one per plan, mean of 5; the plain
    versions mean of 3) beside the bound of the bytes it must move (each
    input once, each output once: the live entries;
    ``ops.roofline.Roofline``) and its time before the redesign
    (``PRIOR_MS``; for (a) also the profiler's device time and the host's
    enqueue per call, since its calls can outpace the host in pattern
    mode), and chunk by chunk ((a), (b), (c) and K5 alone on each
    chunk: L, rows, tiles, live partial products, ms).  No single PyTorch
    call computes these functions, so ``library_ms`` is null.  Returns the
    kernels line's four entries (value mode; pattern mode beside)."""
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss

    W = ss.DEFAULT_SEG_W
    classes = ss._norm_classes(ss.DEFAULT_CLASSES, W)
    sizing = ss._sizing(A, A, W, classes)
    sched, _ = ss._chunk_schedule(classes, sizing.counts, ss.DEFAULT_SLOT_BUDGET)
    slots = sum(L * R for L, R, _, _ in sched)
    nrow = A.nrow
    nnz_pad = ss._round_up(sizing.npa * W, 1024)
    Av = dataclasses.replace(A, data=rng.standard_normal(np.asarray(A.data).shape).astype(np.float32))
    acc = torch.float32
    rows = {}
    for mode, M in (("value", Av), ("pattern", A)):
        pattern = mode == "pattern"
        ref = scipy_square(M.to_scipy())
        plan = ss.spgemm_plan(M, M, device=dev, sizing=sizing, pattern=pattern)
        kws = [dict(L=L, R_pad=R, W=W, accum_dtype=acc, pattern=pattern) for L, R, _, _ in sched]
        where = [(st, c) for _, _, st, c in sched]
        rids = [plan.rows_sorted[st : st + R] for (_, R, st, _) in sched]
        vals = list(plan.aligned_vals) or [None] * len(sched)
        fetch_k = lambda: sk.chunk_fetch_all(plan, sched, W=W, accum_dtype=acc, pattern=pattern)
        fetch_p = lambda: [sk._chunk_fetch(plan, *sk._chunk_meta(plan.rowmeta, st, c, kw["R_pad"], kw["L"] // W),
                                           **kw) for (st, c), kw in zip(where, kws)]
        fused_k = lambda: sk.chunk_merge_all(plan, sched, W=W, accum_dtype=acc, pattern=pattern)
        fused_each = lambda: [sk.chunk_merge(plan, st, c, **kw) for (st, c), kw in zip(where, kws)]
        merge_k = lambda: sk.slab_merge_all(plan.aligned_cols, vals, accum_dtype=acc, pattern=pattern)
        merge_p = lambda: [sk._merge_block(col, v, accum_dtype=acc, pattern=pattern)
                           for col, v in zip(plan.aligned_cols, vals)]
        before = counters()["slab_fetch"]
        fk, fp = fetch_k(), fetch_p()
        require(counters()["slab_fetch"] == before + 1, "K4 (a) is not one launch per plan")
        before = counters()
        b1, b2, c = fused_k(), fused_each(), merge_k()
        mp = merge_p()
        torch.cuda.synchronize()
        groups = len(sk.merge_plan([(L, R) for L, R, _, _ in sched], acc).launches)
        got = {k: counters()[k] - before[k] for k in ("slab_fetch_merge", "slab_merge")}
        require(got == {"slab_fetch_merge": groups + len(sched), "slab_merge": groups},
                f"K4 launches {got}: expected one per block-size group ({groups}) per product, one per chunk "
                f"call ({len(sched)})")
        err = 0.0
        live_pp = 0
        for i, ((ck, vk), (cp, vp)) in enumerate(zip(fk, fp)):
            require(torch.equal(ck, cp) and torch.equal(ck, plan.aligned_cols[i])
                    and (pattern or (torch.equal(vk, vp) and torch.equal(vk, plan.aligned_vals[i]))),
                    f"K4 (a) differs from _chunk_fetch in chunk {i} ({mode} mode)")
            live_pp += int((cp != ss._INT_MAX).sum())
            require(all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(b1[i], b2[i], c[i])),
                    f"K4 (b) over the product, (b) chunk by chunk and (c) on the slab (a) built differ in their "
                    f"bits in chunk {i} ({mode} mode)")
            cols_u, vals_u, nuniq = b1[i]
            require(torch.equal(nuniq, mp[i][2]), f"K4 nuniq differs from _merge_block in chunk {i} ({mode} mode)")
            live = torch.arange(cols_u.shape[1], device=dev)[None, :] < nuniq[:, None]
            require(torch.equal(cols_u[live], mp[i][0][live]), f"K4 columns differ from _merge_block in chunk {i}")
            if pattern:
                require(torch.equal(vals_u[live], mp[i][1][live]), f"K4 pattern counts differ in chunk {i}")
            else:
                exact = sk._merge_block(cp, vp.double(), accum_dtype=torch.float64, pattern=False)[1][live]
                e64, r64 = max_errs(vals_u[live].double(), exact)
                _, r32 = max_errs(vals_u[live], mp[i][1][live])
                require(r64 <= RTOL_F32 and r32 <= 2e-5,
                        f"K4 values in chunk {i}: rel {r64:.3e} from the fp64 merge, {r32:.3e} from the plain one")
                err = max(err, e64)
        outs = [(r,) + o for r, o in zip(rids, b1)]
        before = counters()["slab_compact"]
        ck5 = sk.compact_to_csr(outs, nrow=nrow, nnz_pad=nnz_pad, dtype=acc, device=dev)
        require(counters()["slab_compact"] == before + 1, "K5 is not one launch pair per product")
        cp5 = sk._compact_to_csr(outs, nrow=nrow, nnz_pad=nnz_pad, dtype=acc, device=dev)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(ck5, cp5)), f"K5 differs from _compact_to_csr ({mode} mode)")
        held_against(ss._csr_to_host(ss.CSR(data=ck5[0], indices=ck5[1], indptr=ck5[2], shape=A.shape,
                                            nnz=int(ck5[3]))), ref, f"K5's CSR ({mode} mode)",
                     rtol=None if pattern else 1e-4)
        del fk, fp, b1, b2, c, mp, cp5
        vb = 0 if pattern else 4
        out_nnz, nu_bytes = ref.nnz, 4 * sum(R for _, R, _, _ in sched)
        tables = (plan.rowmeta.numel() * 4 + sizing.npa * (4 + vb) + plan.b2_cols.numel() * 4
                  + plan.b2_vals.numel() * vb)
        merged = out_nnz * 8 + nu_bytes
        work = {  # name: (kernel, plain, bytes, operations)
            "slab_fetch": (fetch_k, fetch_p, tables + slots * (4 + vb), 0 if pattern else live_pp),
            "slab_fetch_merge": (fused_k, lambda: [sk._merge_block(*f, accum_dtype=acc, pattern=pattern)
                                                   for f in fetch_p()], tables + merged, 2 * live_pp),
            "slab_merge": (merge_k, merge_p, slots * (4 + vb) + merged, live_pp),
            "slab_compact": (lambda: sk.compact_to_csr(outs, nrow=nrow, nnz_pad=nnz_pad, dtype=acc, device=dev),
                             lambda: sk._compact_to_csr(outs, nrow=nrow, nnz_pad=nnz_pad, dtype=acc, device=dev),
                             merged + nu_bytes + (nrow + 1) * 8 + out_nnz * 8, 0),
        }
        line = []
        for name, (kern, plain, nbytes, ops_) in work.items():
            ms = cuda_ms(torch, kern, iters=5, warmup=1)
            plain_ms = cuda_ms(torch, plain, iters=3, warmup=1)
            b = bound(nbytes, ops_, peak)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], share=b[0] / ms,
                       bytes=nbytes)
            if mode == "value":
                merges = name in ("slab_fetch_merge", "slab_merge")  # the others are bit-equal to theirs
                rows[name] = dict(max_abs_err=err if merges else 0.0, **row, library_ms=None,
                                  library="none: no single PyTorch call computes this function")
            else:
                rows[name]["pattern"] = row
            paced = ""
            if name == "slab_fetch":  # back-to-back calls can be paced by the host's work per call
                dev_ms, enq = device_and_enqueue(torch, kern, repeats=5)
                paced = f"; device {dev_ms:.4f} ms and enqueue {enq:.0f} µs per call"
            line.append(f"{name} {ms:.4f} ms (plain {plain_ms:.4f}; bound {b[0]:.4f}, {b[1]}, "
                        f"{nbytes / 1e6:.1f} MB, share {b[0] / ms:.1%}{paced}; before the redesign, value / "
                        f"pattern: {PRIOR_MS[name]} ms, PERF.md)")
        say(f"phase 3 K4 / K5 over the web-Google A×A in {mode} mode ({len(sched)} chunks, {slots} slots, "
            f"{live_pp} partial products, {out_nnz} out nnz; K4 (a) one launch, (b) and (c) {groups} launches per "
            f"product): "
            f"(a) bit-equal to _chunk_fetch, (b) and (c) equal to _merge_block on the live slots"
            + ("" if pattern else f" (max_abs_err {err:.3e} from the fp64 merge, tol {RTOL_F32:g} of max)")
            + ", (b) over the product, (b) chunk by chunk and (c) bit-identical, K5 equal to _compact_to_csr and "
            f"to scipy | CUDA events, whole product: " + " | ".join(line)
            + " | library: none (no single PyTorch call computes these)")
        # chunk by chunk: each kernel alone on one chunk (K5 over that
        # chunk's rows, nnz_pad its own entries)
        per = []
        plan_m = sk.merge_plan([(L, R) for L, R, _, _ in sched], acc)
        tiles = {}
        for x in plan_m.launches:
            for k, i in enumerate(x.chunks):
                rows_t = int(x.table[k, sk.MERGE_FIELDS.index("rows_t")])
                tiles[i] = (x.threads, x.items, rows_t, -(-sched[i][1] // rows_t))
        for i, ((L, R, st, c), kw) in enumerate(zip(sched, kws)):
            one = [outs[i]]
            nnz_i = int(outs[i][3].sum())
            ta = cuda_ms(torch, lambda: sk.chunk_fetch(plan, st, c, **kw), iters=5, warmup=1)
            tb = cuda_ms(torch, lambda: sk.chunk_merge(plan, st, c, **kw), iters=5, warmup=1)
            tc = cuda_ms(torch, lambda: sk.slab_merge(plan.aligned_cols[i], vals[i], accum_dtype=acc,
                                                      pattern=pattern), iters=5, warmup=1)
            t5 = cuda_ms(torch, lambda: sk.compact_to_csr(one, nrow=nrow, nnz_pad=nnz_i, dtype=acc, device=dev),
                         iters=5, warmup=1)
            nt, items, rows_t, ntile = tiles[i]
            live_i = int((plan.aligned_cols[i] != ss._INT_MAX).sum())
            per.append(f"L {L} rows {R} ({c} live) tiles {ntile} x {rows_t} rows ({nt} threads x {items}) "
                       f"pp {live_i} nnz {nnz_i}: a {ta:.4f} b {tb:.4f} c {tc:.4f} K5 {t5:.4f}")
        say(f"phase 3 K4 / K5 chunk by chunk ({mode} mode, ms, CUDA events, mean of 5): " + " | ".join(per))
        del plan, outs, ck5
    return rows


def profile_line(p, n: int = 6) -> str:
    """The top ``n`` kernels of a ``utils.profiling.Profile``."""
    return " | ".join(f"{o.name[:60]} x{o.count:g} {o.ms:.3f}" for o in p.ops[:n])


def slab_phase(torch, A, dev, rng, cli_spgemm_ms: float):
    """Phase 5: the slab SpGEMM's entry points at full size, each product held
    against one scipy A×A.  Returns that A×A (phase 6 reuses it) and the
    sizing and times of the cold call, the warm numeric phase and the chain
    (phase 9's attainable shares)."""
    from spmm_tpu_torch import ops
    from spmm_tpu_torch.ops import slab_kernel as sk
    from spmm_tpu_torch.ops import slab_spgemm as ss
    from spmm_tpu_torch.utils.profiling import profile_fn

    timed = functools.partial(host_timed, torch)

    def peak_since(base):
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    def reset():
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    t_phase = t0 = time.perf_counter()
    launches0 = counters()
    ref = scipy_square(A.to_scipy())
    t_ref = (time.perf_counter() - t0) * 1e3
    W = ss.DEFAULT_SEG_W
    classes = ss._norm_classes(ss.DEFAULT_CLASSES, W)
    sizing, t_size = timed(lambda: ss._sizing(A, A, W, classes))
    sched, _ = ss._chunk_schedule(classes, sizing.counts, ss.DEFAULT_SLOT_BUDGET)
    exp_pad = sizing.npa * W
    slots = sum(L * R for L, R, _, _ in sched)
    say(f"phase 5 setup: scipy A×A {ref.nnz} nnz ({t_ref:.1f} ms host) | sizing {t_size:.1f} ms: "
        f"npa {sizing.npa}, padded expansion {exp_pad}, {len(sched)} chunks, {slots} slab slots, "
        f"tail rows {sizing.counts[-1]}")

    # plan (aligned cache) and its numeric phase
    base = reset()
    plan, t_plan_first = timed(lambda: ss.spgemm_plan(A, A, device=dev, sizing=sizing))
    del plan
    before = counters()["slab_fetch"]
    plan, t_plan = timed(lambda: ss.spgemm_plan(A, A, device=dev, sizing=sizing))
    plan_gb = (torch.cuda.memory_allocated() - base) / 1e9
    require(counters()["slab_fetch"] == before + 1, "the plan build is not one K4 (a) launch")
    # new values on the plan's structure: the whole cache fetched again (K4
    # a), in value mode, and its numeric phase held against scipy
    Av = dataclasses.replace(A, data=rng.standard_normal(np.asarray(A.data).shape).astype(np.float32))
    ref_v = scipy_square(Av.to_scipy())
    before = counters()["slab_fetch"]
    plan_v, t_revalue = timed(lambda: ss.spgemm_plan_revalue(plan, Av, Av))
    require(counters()["slab_fetch"] == before + 1 and not plan_v.pattern,
            "spgemm_plan_revalue is not one K4 (a) launch into a value-mode cache")
    outs_v, _, _ = ss.spgemm_slab_device(Av, Av, plan_v)
    err_rev = held_against(ss._csr_to_host(ss._csr_of(outs_v, (A.nrow, A.ncol), ss._round_up(sizing.npa * W, 1024),
                                                      torch.float32, dev)), ref_v, "spgemm_plan_revalue", rtol=1e-4)
    del plan_v, outs_v
    (outs, _, _), t_num_first = timed(lambda: ss.spgemm_slab_device(A, A, plan))
    num_ms = cuda_ms(torch, lambda: ss.spgemm_slab_device(A, A, plan), iters=5)
    chain_ms = cuda_ms(torch, lambda: ss.spgemm_chain_device(plan, 8), iters=1, warmup=1) / 8
    nnz_pad = ss._round_up(exp_pad, 1024)
    Cd, t_compact = timed(lambda: ss._csr_of(outs, (A.nrow, A.ncol), nnz_pad, torch.float32, dev))
    Ch, t_d2h = timed(lambda: ss._csr_to_host(Cd))
    held_against(Ch, ref, "plan numeric")
    peak_plan = peak_since(base)
    groups = len(sk.merge_plan([(L, R) for L, R, _, _ in sched], torch.float32).launches)
    before = counters()
    chain2 = ss.spgemm_chain_device(plan, 2)
    got = {k: counters()[k] - before[k] for k in SPGEMM_KERNELS}
    require(got == {"slab_fetch": 0, "slab_fetch_merge": 0, "slab_merge": 2 * groups, "slab_compact": 0},
            f"a chain of 2 products took {got} launches, not {groups} K4 (c) per product")
    held_against(ss._csr_of(chain2, (A.nrow, A.ncol), nnz_pad, torch.float32, dev), ref, "spgemm_chain_device")
    del chain2
    say(f"phase 5 plan: build {t_plan:.1f} ms (first {t_plan_first:.1f}), tables + aligned cache "
        f"{plan_gb:.3f} GB | revalue with new values {t_revalue:.1f} ms (host, one K4 (a) launch; its product "
        f"max_abs_err {err_rev:.3e}, tol 1e-4 of max {float(np.abs(ref_v.data).max()):.3e}) | numeric {num_ms:.3f} ms (CUDA events, first {t_num_first:.1f} ms host) | "
        f"chain {chain_ms:.3f} ms/product (8, one sync) | compaction {t_compact:.1f} ms | "
        f"D2H {t_d2h:.1f} ms | peak {peak_plan:.3f} GB | numeric and chain exact")

    # the device stages apart: the torch stages as the port first wrote them
    # (S2 expansion, the chunks' gathers, which the aligned cache runs once;
    # S1 sort+merge of the aligned cache; S3 compaction) beside the kernels
    # that replace them (K4 (b) S2 + S1 fused, K4 (c) S1 from the aligned
    # cache, which is the warm numeric phase above, K5 S3)
    def fetch_all():
        for L, R_pad, start, cnt in sched:
            base_, bm = ss._chunk_meta(plan.rowmeta, start, cnt, R_pad, L // W)
            ss._chunk_fetch(plan, base_, bm, L=L, R_pad=R_pad, W=W, accum_dtype=torch.float32,
                            pattern=plan.pattern)

    def fused_all():
        ss._chunks(plan, sched, W=W, accum_dtype=torch.float32, pattern=plan.pattern)

    def merge_plain():
        for col in plan.aligned_cols:
            ss._merge_block(col, None, accum_dtype=torch.float32, pattern=plan.pattern)

    def compact(fn):
        return lambda: fn(outs, nrow=A.nrow, nnz_pad=nnz_pad, dtype=torch.float32, device=dev)

    require(plan.pattern, "phase 5's A×A is not in pattern mode")
    s2_ms = cuda_ms(torch, fetch_all, iters=3, warmup=1)
    s1_ms = cuda_ms(torch, merge_plain, iters=3, warmup=1)
    s3_ms = cuda_ms(torch, compact(ss._compact_to_csr), iters=3, warmup=1)
    k4b_ms = cuda_ms(torch, fused_all, iters=5, warmup=1)
    k5_ms = cuda_ms(torch, compact(ss.compact_to_csr), iters=5, warmup=1)
    say(f"phase 5 stages (CUDA events, pattern mode): torch S2 expansion {s2_ms:.3f} ms | torch S1 sort+merge "
        f"{s1_ms:.3f} ms | torch S3 compaction {s3_ms:.3f} ms || K4 (b) S2 + S1 fused {k4b_ms:.3f} ms | K4 (c) "
        f"S1 from the aligned cache {num_ms:.3f} ms (the warm numeric phase) | K5 S3 {k5_ms:.3f} ms")
    p = profile_fn(lambda: ss.spgemm_slab_device(A, A, plan), repeats=3, warm=False)
    say(f"phase 5 profile, warm numeric (device ms per product, busy {p.total_device_ms:.3f}): by op: "
        + " | ".join(f"{src} {ms:.3f}" for src, ms in list(p.by_source().items())[:6])
        + " || by kernel: " + profile_line(p))
    del outs, Cd, Ch, plan

    base = reset()
    Cdev, t_csr = timed(lambda: ss.spgemm_slab_csr(A, A, device=dev, sizing=sizing))
    peak_csr = peak_since(base)
    held_against(Cdev, ref, "spgemm_slab_csr")
    del Cdev
    say(f"phase 5 device CSR: spgemm_slab_csr {t_csr:.1f} ms (sizing given) | peak {peak_csr:.3f} GB "
        f"= {peak_csr * 1e9 / exp_pad:.2f} B per padded-expansion slot | exact")

    ss._PLAN_SEEN.clear()
    ss._PLAN_CACHE.clear()
    t_calls, peaks = [], []
    for i in range(3):
        base = reset()
        C, t = timed(lambda: ops.spgemm(A, A, device=dev))
        held_against(C, ref, f"ops.spgemm call {i + 1}")
        t_calls.append(t)
        peaks.append(peak_since(base))
    require(len(ss._PLAN_CACHE) == 1, "ops.spgemm did not keep its plan")
    say(f"phase 5 ops.spgemm: call 1 {t_calls[0]:.1f} ms | call 2 (plan build) {t_calls[1]:.1f} ms | "
        f"call 3 (plan reuse) {t_calls[2]:.1f} ms | peaks {', '.join(f'{p:.3f}' for p in peaks)} GB | "
        f"the CLI's first SpGEMM in this process {cli_spgemm_ms:.1f} ms | each exact")
    # the device's idle share of one call, plan reuse and then without a plan
    idle = []
    for label in ("plan reuse", "no plan"):
        t_call = []
        p = profile_fn(lambda: t_call.append(timed(lambda: ops.spgemm(A, A, device=dev))[1]), warm=False)
        t, busy = t_call[0], p.total_device_ms
        copies = sum(o.ms for o in p.ops if o.name.startswith("Memcpy"))
        idle.append(f"{label}: {t:.1f} ms under the profiler, device busy {busy:.3f} ms "
                    f"(copies {copies:.3f}), idle {100 * (1 - busy / t):.1f}%")
        ss._PLAN_SEEN.clear()
        ss._PLAN_CACHE.clear()
    say("phase 5 idle share of ops.spgemm: " + " | ".join(idle))

    Cv, t_v = timed(lambda: ops.spgemm(Av, Av, device=dev))
    err_v = held_against(Cv, ref_v, "value-mode ops.spgemm", rtol=1e-4)
    Cs, t_sorted = timed(lambda: ops.spgemm_sorted(A, A, device=dev))
    held_against(Cs, ref, "spgemm_sorted")
    say(f"phase 5 value mode: ops.spgemm {t_v:.1f} ms, max_abs_err {err_v:.3e} (tol 1e-4 of max "
        f"{float(np.abs(ref_v.data).max()):.3e}) | spgemm_sorted {t_sorted:.1f} ms, exact")
    del Cv, Cs, ref_v

    calls = []
    real = ss._piece_exec
    ss._piece_exec = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        with tempfile.TemporaryDirectory() as ck:
            base = reset()
            Cb, t_big = timed(lambda: ss.spgemm_slab_big(A, A, pieces=4, device=dev, checkpoint_dir=ck))
            peak_big = peak_since(base)
            held_against(Cb, ref, "spgemm_slab_big")
            n_first = len(calls)
            calls.clear()
            Cb, t_resume = timed(lambda: ss.spgemm_slab_big(A, A, pieces=4, device=dev, checkpoint_dir=ck))
            held_against(Cb, ref, "spgemm_slab_big resumed")
    finally:
        ss._piece_exec = real
    require(n_first == 4, f"spgemm_slab_big ran {n_first} pieces, not 4")
    require(not calls, f"the resume recomputed {len(calls)} pieces")
    moved = {k: n - launches0[k] for k, n in counters().items() if k in SPGEMM_KERNELS}
    for kname, n in moved.items():
        require(n > 0, f"kernel {kname} was not launched by the slab SpGEMM's entry points (phase 5)")
    say(f"phase 5 big path: 4 pieces {t_big:.1f} ms, peak {peak_big:.3f} GB, exact | resume "
        f"{t_resume:.1f} ms, 0 pieces recomputed, exact | K4 / K5 launches in phase 5 (timing repeats "
        f"included) {moved} | phase 5 took {time.perf_counter() - t_phase:.1f} s")
    # what phase 9's attainable bounds need: the sizing and the times
    return ref, dict(sizing=sizing, out_nnz=ref.nnz, cold_ms=t_calls[0], warm_ms=num_ms,
                     chain_ms=chain_ms)


def blocked_phase(torch, A, E, Ab, A_band, ref_C, dev, rng, paths, k2_ell_ms: float) -> dict:
    """Phase 6: the BlockedCSR SpMM (the driver's single-chip forward) and
    the rest of slice 3 at web-Google size.  Every entry point runs once
    (the path, with the launch counts set to 0 by the caller), then each
    result is held against scipy or its plain version and timed.  Returns
    each kernel's launch count at the end of the path run, and the packed
    matrix and its slab view (phase 7 differentiates through them)."""
    from spmm_tpu_torch import ops
    from spmm_tpu_torch.config import Config
    from spmm_tpu_torch.entry import entry
    from spmm_tpu_torch.formats import ell_pack_device
    from spmm_tpu_torch.ops import blocked as bl
    from spmm_tpu_torch.ops import bsr_kernel, ell_kernel
    from spmm_tpu_torch.preprocess import bitmap_perm_device, bitmap_reorder, preprocess
    from spmm_tpu_torch.utils.profiling import profile_fn

    spmm_mod = importlib.import_module("spmm_tpu_torch.ops.spmm")  # ops.spmm is the function

    timed = functools.partial(host_timed, torch)

    def within(y, ref, tol, what):
        """max |y - ref| <= tol * max |ref| (numpy or tensors); returns the
        max error over max |ref|."""
        y, ref = (a.cpu().numpy() if hasattr(a, "cpu") else a for a in (y, ref))
        err, scale = float(np.abs(y - ref).max()), float(np.abs(ref).max())
        require(err <= tol * scale, f"{what}: max err {err:.3e} > {tol:g} * {scale:.3e}")
        return err / scale

    def k2_calls(name, fn, want):
        return launched(paths, name, fn, {"ell_slab_spmm": want})

    t_phase = time.perf_counter()
    S = A.to_scipy()
    # 1. preprocess and views (host clock)
    P_host, t_pre = timed(lambda: preprocess(A, Config()))
    P, t_h2d = timed(lambda: P_host.to(dev))
    view, t_view = timed(lambda: ops.blocked_slab_view(P))
    pview, t_pview = timed(lambda: ops.blocked_slab_view(P, panel=True))
    ev, t_ev = timed(lambda: ops.blocked_exec_view(P))
    pv, t_pv = timed(lambda: ops.blocked_panel_view(P))
    buckets = view[0]
    in_groups = sum(int(c.numel()) for _, c in buckets)
    n_left = A.nrow - sum(int(c.shape[0]) for _, c in buckets)
    Ls = [int(c.shape[1]) for _, c in buckets]
    say(f"phase 6 setup: preprocess {t_pre:.1f} ms (host) | H2D {t_h2d:.1f} ms | slab view "
        f"{t_view:.1f} ms, panel slab view {t_pview:.1f} ms, exec view {t_ev:.1f} ms, panel view "
        f"{t_pv:.1f} ms | {P.ngroups} v8 groups in {len(buckets)} buckets (L {min(Ls)}-{max(Ls)}), "
        f"{in_groups} of {A.nnz} nnz in groups, {n_left} leftover rows with {int(view[1][0].numel())} "
        f"nnz | {P.nregions} regions, {P.ndistinct} panel columns")

    B = torch.from_numpy(rng.standard_normal((A.ncol, 128)).astype(np.float32)).to(dev)
    B32 = torch.from_numpy(rng.standard_normal((A.ncol, 32)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal(A.ncol).astype(np.float32)).to(dev)
    xb = torch.from_numpy(rng.standard_normal(A_band.shape[1]).astype(np.float32)).to(dev)
    U = torch.from_numpy(rng.standard_normal((A.nrow, 128)).astype(np.float32)).to(dev)
    V = torch.from_numpy(rng.standard_normal((A.ncol, 128)).astype(np.float32)).to(dev)
    A_dev = A.pad(1024).to(dev)

    # 2. the path: every entry point once
    host_packs = []
    real_pack = spmm_mod.ell_pack
    spmm_mod.ell_pack = lambda *a, **k: host_packs.append(1) or real_pack(*a, **k)
    y_slab = k2_calls("ops.blocked_spmm_slab", lambda: ops.blocked_spmm_slab(P, B, view), 1)
    y_pslab = k2_calls("ops.blocked_spmm_slab (panel view)", lambda: ops.blocked_spmm_slab(P, B, pview), 1)
    y_disp = k2_calls("ops.spmm(BlockedCSR)", lambda: ops.spmm(P, B), 1)
    y_xla = k2_calls("ops.blocked_spmm_xla", lambda: ops.blocked_spmm_xla(P, B, view=ev), 0)
    y_panel = k2_calls("ops.blocked_spmm_panel", lambda: ops.blocked_spmm_panel(P, B, view=pv), 0)
    y_chain = k2_calls("ops.blocked_chain_spmv", lambda: ops.blocked_chain_spmv(P, x, 3), 0)
    Cd, t_csr = timed(lambda: ops.spgemm_slab_csr(A, A, device=dev))
    y_c, t_cspmm_first = timed(lambda: k2_calls("ops.spmm(device CSR)", lambda: ops.spmm(Cd, B32), 1))
    Ec = spmm_mod._ell_of(Cd, dev)
    spmm_mod.ell_pack = real_pack
    require(not host_packs, "ops.spmm(device CSR) packed on the host")
    require(all(t.is_cuda for t in (*Ec.data, *Ec.cols, Ec.perm, Ec.inv_perm, Ec.rest.data)),
            "the device CSR's ELL pack has leaves off the card")
    perm_d = bitmap_perm_device(A_dev, 2048)
    y_bsrv = ops.bsr_spmv(Ab, xb)
    C_sd = ops.sddmm(A_dev, U, V)
    fn, args = entry(dev)
    y_entry = k2_calls("entry.entry (blocked_spmm_slab)", lambda: fn(*args), 1)
    torch.cuda.synchronize()
    path_launches = counters()

    # 3. checks
    ref = S @ B.cpu().numpy()
    err_slab = within(y_slab, bl.blocked_spmm_slab_reference(P, B, view), RTOL_F32,
                      "blocked_spmm_slab vs its plain version")
    err_slab_sp = within(y_slab, ref, 1e-4, "blocked_spmm_slab vs scipy")
    for y, what in ((y_pslab, "panel-view slab"), (y_disp, "ops.spmm(BlockedCSR)"),
                    (y_xla, "blocked_spmm_xla"), (y_panel, "blocked_spmm_panel")):
        within(y, ref, 1e-4, f"{what} vs scipy")
    xh = x.cpu().numpy()
    err_chain = within(y_chain, S @ (S @ (S @ xh)), 1e-4, "blocked_chain_spmv (3) vs scipy")
    err_c = within(y_c, ref_C @ B32.cpu().numpy(), 1e-4, "ops.spmm(device CSR) vs scipy C @ B")
    _, perm_h = bitmap_reorder(A, 2048, materialize=False)
    require(np.array_equal(perm_d.cpu().numpy(), perm_h), "bitmap_perm_device differs from the host's")
    xbh = xb.cpu().numpy().astype(np.float64)
    err_bsrv = within(y_bsrv, A_band.to_scipy().astype(np.float64) @ xbh, 1e-4, "bsr_spmv vs scipy fp64")
    sample = np.random.default_rng(6).choice(A.nnz, 10_000, replace=False)
    rows = np.searchsorted(A.indptr, sample, side="right") - 1
    cols = A.indices[sample]
    ref_sd = np.einsum("ij,ij->i", U.cpu().numpy()[rows].astype(np.float64),
                       V.cpu().numpy()[cols].astype(np.float64))
    sd = C_sd.data.cpu().numpy()
    err_sd = within(sd[sample], ref_sd, 1e-5, "sddmm sample vs numpy fp64")
    require(not np.any(sd[A.nnz:]), "sddmm left a nonzero in the padding")
    err_entry = within(y_entry, bl.blocked_spmm_slab_reference(*args), RTOL_F32,
                       "entry() vs its plain version")
    say(f"phase 6 checks (max err / max |ref|): slab vs plain {err_slab:.3e} (tol {RTOL_F32:g}), "
        f"vs scipy {err_slab_sp:.3e}; panel slab, dispatcher, xla, panel within 1e-4 | "
        f"chain {err_chain:.3e} | device-CSR SpMM k=32 {err_c:.3e} | bitmap_perm_device equal | "
        f"bsr_spmv {err_bsrv:.3e} | "
        f"sddmm {err_sd:.3e}, padding zero | entry {err_entry:.3e} | launches on the path "
        f"{path_launches}")

    # 4. times (CUDA events, mean of 10 unless said; host clock for set-up)
    ms = {
        "slab": cuda_ms(torch, lambda: ops.blocked_spmm_slab(P, B, view)),
        "slab plain": cuda_ms(torch, lambda: bl.blocked_spmm_slab_reference(P, B, view), iters=5),
        "panel slab": cuda_ms(torch, lambda: ops.blocked_spmm_slab(P, B, pview)),
        "xla": cuda_ms(torch, lambda: ops.blocked_spmm_xla(P, B, view=ev)),
        "panel": cuda_ms(torch, lambda: ops.blocked_spmm_panel(P, B, view=pv)),
        "ell_spmm": cuda_ms(torch, lambda: ops.ell_spmm(E, B)),
        "chain3": cuda_ms(torch, lambda: ops.blocked_chain_spmv(P, x, 3)),
        "spmm Cd k=32": cuda_ms(torch, lambda: ops.spmm(Cd, B32)),
        "perm": cuda_ms(torch, lambda: bitmap_perm_device(A_dev, 2048)),
        "bsr_spmv": cuda_ms(torch, lambda: ops.bsr_spmv(Ab, xb)),
        "sddmm": cuda_ms(torch, lambda: ops.sddmm(A_dev, U, V), iters=5),
        "entry": cuda_ms(torch, lambda: fn(*args)),
        "entry plain": cuda_ms(torch, lambda: bl.blocked_spmm_slab_reference(*args)),
    }
    prof = profile_fn(lambda: ops.blocked_spmm_slab(P, B, view), repeats=3, warm=False)
    _, t_pack_dev = timed(lambda: ell_pack_device(Cd))
    _, t_pack_host = timed(lambda: real_pack(Cd).to(dev))
    _, t_perm_host = timed(lambda: bitmap_reorder(A, 2048, materialize=False))
    say(f"phase 6 times k=128 (CUDA events): blocked_spmm_slab {ms['slab']:.4f} ms (one K2 launch over "
        f"{len(buckets)} buckets) | its plain version {ms['slab plain']:.4f} | panel-view slab {ms['panel slab']:.4f} | "
        f"blocked_spmm_xla {ms['xla']:.4f} | blocked_spmm_panel {ms['panel']:.4f} | ops.ell_spmm over the "
        f"ELL pack {ms['ell_spmm']:.4f} (phase 3: K2 over its slabs {k2_ell_ms:.4f})")
    say(f"phase 6 times: chain 3 iters {ms['chain3']:.4f} ms | device CSR ({Cd.nnz} nnz, spgemm_slab_csr "
        f"{t_csr:.1f} ms host): ell_pack_device {t_pack_dev:.1f} ms host, host ell_pack + H2D "
        f"{t_pack_host:.1f} ms host, {len(Ec.data)} slabs; ops.spmm k=32 first call (pack + SpMM) "
        f"{t_cspmm_first:.1f} ms host, then {ms['spmm Cd k=32']:.4f} ms | bitmap_perm_device "
        f"{ms['perm']:.4f} ms vs host bitmap_reorder {t_perm_host:.1f} ms | bsr_spmv {ms['bsr_spmv']:.4f} | "
        f"sddmm k=128 {ms['sddmm']:.4f} | entry() {ms['entry']:.4f} vs plain {ms['entry plain']:.4f} | "
        f"phase 6 took {time.perf_counter() - t_phase:.1f} s")
    say(f"phase 6 profile, blocked_spmm_slab k=128 (device ms per call, busy "
        f"{prof.total_device_ms:.3f}): by kernel: " + profile_line(prof))
    return path_launches, P, view


def grad_phase(torch, A, E, Ab, A_band, P, view, dev, rng, paths, root) -> dict:
    """Phase 7, this slice's path at web-Google size: gradients through the
    SpMM kernels, fp64 on the kernels, and the four example programs.
    Returns each kernel's launches on the phase's path: those of the path's
    own calls, none of the timing and profiling repeats beside them."""
    import importlib.util

    from spmm_tpu_torch import ops
    from spmm_tpu_torch.formats import ell_pack, webgraph_like
    from spmm_tpu_torch.ops import blocked as bl
    from spmm_tpu_torch.ops import bsr_kernel
    from spmm_tpu_torch.utils.profiling import profile_fn

    timed = functools.partial(host_timed, torch)
    t_phase = time.perf_counter()
    tally = dict.fromkeys(counters(), 0)

    def on_path(name, fn, want=None):
        """One call of the path: traced, counted into ``tally``, and held to
        the launch counts in ``want``."""
        return launched(paths, name, fn, want or {}, tally)

    def within(y, ref, tol, what):
        y, ref = (a.detach().cpu().numpy() if hasattr(a, "cpu") else a for a in (y, ref))
        err, scale = float(np.abs(y - ref).max()), float(np.abs(ref).max())
        require(err <= tol * scale, f"{what}: max err {err:.3e} > {tol:g} * {scale:.3e}")
        return err / scale

    def same_bits(g1, g2, what):
        require(all(torch.equal(a, b) for a, b in zip(g1, g2, strict=True)),
                f"{what}: two backward runs differ in their bits")

    def plain_grad(fn, *leaves):
        """The gradient of sum(fn()**2) by autograd of plain torch ops."""
        return torch.autograd.grad((fn() ** 2).sum(), leaves)

    # ---- (a) sum(spmm(A, B)**2): forward and backward, k = 128 ---------------
    k = 128
    S = A.to_scipy()
    B0 = rng.standard_normal((A.ncol, k)).astype(np.float32)
    Y0 = S @ B0
    ref_g = 2.0 * (S.T @ Y0)
    B = torch.from_numpy(B0).to(dev).requires_grad_()
    Eg = dataclasses.replace(E, data=tuple(d.clone().requires_grad_() for d in E.data))

    def ell_fb():
        return torch.autograd.grad((ops.ell_spmm(Eg, B) ** 2).sum(), [B, *Eg.data])

    def ell_fb_B():
        return torch.autograd.grad((ops.ell_spmm(E, B) ** 2).sum(), [B])

    want = {"ell_slab_spmm": 2, "ell_slab_spmm_transposed": 1, "ell_slab_sddmm": 1, "bsr_spmm": 0}
    g1, t_first = timed(lambda: on_path("ops.ell_spmm + backward (B and slab values)", ell_fb, want))
    g2 = on_path("ops.ell_spmm + backward (B and slab values)", ell_fb, want)
    same_bits(g1, g2, "ell_spmm")
    on_path("ops.ell_spmm + backward (B)", ell_fb_B, {**want, "ell_slab_sddmm": 0})
    err_sp = within(g1[0], ref_g, 1e-4, "ell_spmm grad B vs scipy 2 Aᵀ(A B)")
    A_dev = A.pad(1024).to(dev)
    Bp = B.detach().clone().requires_grad_()
    err_pl = within(g1[0], plain_grad(lambda: ops.spmm_xla(A_dev, Bp), Bp)[0], 1e-4,
                    "ell_spmm grad B vs the plain gather + index_add_ gradient")
    # the slab values' gradient, 2 Y[row] . B[col], on a sample of slots
    cols_flat = np.concatenate([c.cpu().numpy().reshape(-1) for c in E.cols])
    rows_flat = np.concatenate([np.repeat(np.arange(c.shape[0]), c.shape[1]) for c in E.cols])
    row0 = np.cumsum([0] + [int(c.shape[0]) for c in E.cols])
    rows_flat = rows_flat + np.repeat(row0[:-1], [int(c.numel()) for c in E.cols])
    perm = E.perm.cpu().numpy()[E.n_empty:]
    sample = rng.choice(len(cols_flat), 10_000, replace=False)
    want_v = 2.0 * np.einsum("ij,ij->i", Y0[perm[rows_flat[sample]]].astype(np.float64),
                             B0[np.clip(cols_flat[sample], 0, A.ncol - 1)].astype(np.float64))
    gv = torch.cat([g.reshape(-1) for g in g1[1:]])[torch.from_numpy(sample).to(dev)]
    err_v = within(gv, want_v, 1e-4, "ell_spmm grad of the slab values vs 2 Y[row].B[col]")
    ms = {"ell fwd": cuda_ms(torch, lambda: ops.ell_spmm(E, B.detach())),
          "ell fwd+bwd B": cuda_ms(torch, ell_fb_B, iters=5),
          "ell fwd+bwd B+values": cuda_ms(torch, ell_fb, iters=5)}
    prof_ell = profile_fn(ell_fb, repeats=3, warm=False)
    say(f"phase 7a ell_spmm k={k} loss sum(Y**2): grad B vs scipy {err_sp:.3e}, vs the plain gradient "
        f"{err_pl:.3e} (tol 1e-4 of max) | slab values' grad on 10,000 slots {err_v:.3e} | two backward runs "
        f"bit-identical | launches per forward + backward: K2 2 (1 on the transposed pack), K3 1 | first "
        f"call (builds the work tables and the transposed pack) {t_first:.1f} ms host | forward "
        f"{ms['ell fwd']:.4f} ms, forward + backward (B) {ms['ell fwd+bwd B']:.4f} ms, (B and values) "
        f"{ms['ell fwd+bwd B+values']:.4f} ms (CUDA events)")
    say(f"phase 7a profile, ell_spmm forward + backward (device ms per step, busy "
        f"{prof_ell.total_device_ms:.3f}): " + profile_line(prof_ell, 8))
    del g1, g2, gv, Eg

    Bb = B.detach().clone().requires_grad_()

    def blocked_fb():
        return torch.autograd.grad((ops.blocked_spmm_slab(P, Bb, view) ** 2).sum(), [Bb])

    gb = on_path("ops.blocked_spmm_slab + backward (B)", blocked_fb,
                  {"ell_slab_spmm": 2, "ell_slab_spmm_transposed": 1, "ell_slab_sddmm": 0})
    err_b_sp = within(gb[0], ref_g, 1e-4, "blocked_spmm_slab grad B vs scipy")
    err_b_pl = within(gb[0], plain_grad(lambda: bl.blocked_spmm_slab_reference(P, Bp, view), Bp)[0], 1e-4,
                      "blocked_spmm_slab grad B vs its plain version's gradient")
    ms["blocked fwd+bwd"] = cuda_ms(torch, blocked_fb, iters=5)
    say(f"phase 7a blocked_spmm_slab k={k}: grad B vs scipy {err_b_sp:.3e}, vs the plain version's gradient "
        f"{err_b_pl:.3e} | one K2 forward + one K2 launch on the transposed view | forward + backward "
        f"{ms['blocked fwd+bwd']:.4f} ms")
    del gb, Bb, Bp, A_dev

    Sb = A_band.to_scipy()
    Bk0 = rng.standard_normal((A_band.shape[1], k)).astype(np.float32)
    ref_k = 2.0 * (Sb.T @ (Sb @ Bk0))
    Bk = torch.from_numpy(Bk0).to(dev).requires_grad_()
    blocks = Ab.data.clone().requires_grad_()
    Abg = dataclasses.replace(Ab, data=blocks)

    def bsr_fb():
        return torch.autograd.grad((ops.spmm(Abg, Bk) ** 2).sum(), [Bk, blocks])

    want1 = {"bsr_spmm": 1, "bsr_spmm_transposed": 1, "ell_slab_spmm": 0}
    k1a = on_path("ops.spmm(BSR) + backward (B and blocks)", bsr_fb, want1)
    k1b = on_path("ops.spmm(BSR) + backward (B and blocks)", bsr_fb, want1)
    same_bits(k1a, k1b, "ops.spmm(BSR)")
    err_k_sp = within(k1a[0], ref_k, 1e-4, "ops.spmm(BSR) grad B vs scipy")
    Bkp, dp = Bk.detach().clone().requires_grad_(), blocks.detach().clone().requires_grad_()
    pB, pD = plain_grad(lambda: bsr_kernel.bsr_spmm_reference(dataclasses.replace(Ab, data=dp), Bkp), Bkp, dp)
    err_k_pl = within(k1a[0], pB, 1e-4, "ops.spmm(BSR) grad B vs the plain version's gradient")
    err_k_d = within(k1a[1], pD, 1e-4, "ops.spmm(BSR) grad blocks vs the plain version's gradient")
    ms["bsr fwd+bwd"] = cuda_ms(torch, bsr_fb, iters=5)
    say(f"phase 7a ops.spmm(BSR) k={k}: grad B vs scipy {err_k_sp:.3e}, vs the plain gradient {err_k_pl:.3e}; "
        f"grad blocks (torch.bmm) vs the plain gradient {err_k_d:.3e} | two backward runs bit-identical | K1 1 "
        f"launch, its transposed kernel 1 | forward + backward {ms['bsr fwd+bwd']:.4f} ms")
    del k1a, k1b, pB, pD, Bkp, dp, blocks, Abg

    # ---- (b) fp64 on the kernels -------------------------------------------
    A64 = dataclasses.replace(A, data=rng.standard_normal(A.nnz_pad) * (np.arange(A.nnz_pad) < A.nnz))
    S64 = A64.to_scipy()
    E64 = ell_pack(A64).to(dev)
    B64 = rng.standard_normal((A.ncol, k))
    B64d = torch.from_numpy(B64).to(dev)
    y64 = on_path("ops.ell_spmm fp64", lambda: ops.ell_spmm(E64, B64d, accum_dtype=torch.float64),
                   {"ell_slab_spmm": 1})
    require(y64.dtype == torch.float64, f"fp64 ell_spmm returned {y64.dtype}")
    err64 = within(y64, S64 @ B64, 1e-12, "fp64 ell_spmm vs scipy")
    Ab64 = dataclasses.replace(Ab, data=Ab.data.double())
    yk64 = on_path("ops.spmm(BSR) fp64", lambda: ops.spmm(Ab64, Bk.detach().double()), {"bsr_spmm": 1})
    errk64 = within(yk64, Sb.astype(np.float64) @ Bk0.astype(np.float64), 1e-12, "fp64 ops.spmm(BSR) vs scipy")
    C64, t_c64 = timed(lambda: ops.spgemm(A64, A64, device=dev, accum_dtype=torch.float64))
    require(np.asarray(C64.data).dtype == np.float64, "fp64 ops.spgemm returned another dtype")
    errc64 = held_against(C64, scipy_square(S64), "fp64 value-mode ops.spgemm", rtol=1e-10)
    say(f"phase 7b fp64: ell_spmm k={k} vs scipy {err64:.3e} (tol 1e-12 of max), one fp64 K2 launch | "
        f"ops.spmm(BSR) {errk64:.3e}, one fp64 K1 launch | value-mode ops.spgemm(accum_dtype=float64) "
        f"{t_c64:.1f} ms, structure exact, max_abs_err {errc64:.3e} (tol 1e-10 of max)")
    del E64, B64d, y64, Ab64, yk64, C64, S64, A64

    # ---- (c) the four example programs ---------------------------------------
    def example(name):
        spec = importlib.util.spec_from_file_location(name, os.path.join(root, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    n = A.nrow
    before = counters()["ell_slab_spmm"]
    st = {}
    ranks, used = on_path("examples/pagerank_torch.pagerank (ell_spmv, K2 at k=1)",
                         lambda: example("pagerank_torch").pagerank(A, iters=50, stats=st))
    require(counters()["ell_slab_spmm"] - before == 50, "pagerank did not launch K2 once per iteration")
    d = np.asarray(S.sum(axis=1)).ravel().astype(np.float64)
    inv = np.where(d > 0, 1.0 / np.maximum(d, 1e-30), 0.0)
    Pt = (S.astype(np.float64).multiply(inv[:, None])).T.tocsr()
    x = np.full(n, 1.0 / n)
    for _ in range(50):
        x = 0.85 * (Pt @ x + x[d == 0].sum() / n) + 0.15 / n
    require(abs(float(ranks.sum()) - 1.0) < 1e-3, f"pagerank ranks sum to {ranks.sum()}")
    err_pr = within(ranks, x, 1e-3, "pagerank vs a scipy fp64 power iteration")
    say(f"phase 7c pagerank: {n} nodes, 50 iterations ({used} to tol), sum {ranks.sum():.6f}, vs scipy "
        f"{err_pr:.3e} of max | {st['loop_ms'] / 50:.4f} ms per iteration (host clock, one K2 launch each)")
    prof_pr = profile_fn(lambda: example("pagerank_torch").pagerank(A, iters=10), warm=False)
    say(f"phase 7c profile, pagerank with 10 iterations, the pack's copies included (device ms, busy "
        f"{prof_pr.total_device_ms:.3f}): " + profile_line(prof_pr, 8))

    cg_mod = example("cg_solver_torch")
    L, t_L = timed(lambda: cg_mod.laplacian_system(A))
    b = rng.standard_normal(n).astype(np.float32)
    st = {}
    xs, hist = on_path("examples/cg_solver_torch.cg (ell_spmv, K2 at k=1)",
                      lambda: cg_mod.cg(L, b, iters=200, stats=st))
    # F6: no atomic sum is left in the product, so a second run gives the same bits
    xs2, hist2 = on_path("examples/cg_solver_torch.cg (ell_spmv, K2 at k=1)",
                         lambda: cg_mod.cg(L, b, iters=200))
    require(np.array_equal(hist, hist2) and np.array_equal(xs, xs2),
            "cg: two runs give residual histories that differ in their bits")
    bn = float(np.linalg.norm(b))
    res = float(np.linalg.norm(L.to_scipy().astype(np.float64) @ xs.astype(np.float64) - b)) / bn
    rec, first = float(hist[-1]) / bn, float(hist[0]) / bn
    peak = float(hist.max()) / bn
    # 200 steps do not solve this system in fp32 (eps = 1e-2 under hubs of
    # degree 3e5: a condition number near 1e8); the residual must have come
    # down to a tenth of what it was after the first step, and be the one
    # scipy computes from x
    require(np.isfinite(xs).all() and rec <= 0.1 * first,
            f"cg: the residual did not fall tenfold (after one step {first:.3e}, last {rec:.3e} of |b|)")
    require(abs(res - rec) <= 0.05 * max(res, rec) + 1e-3,
            f"cg: the recurrence's residual {rec:.3e} and scipy's {res:.3e} part")
    say(f"phase 7c cg: Laplacian system {L.nnz} nnz ({t_L:.1f} ms host), {len(hist)} iterations, residual "
        f"{rec:.3e} of |b| by the recurrence, {res:.3e} by scipy from x (peak {peak:.3e}, after one step "
        f"{first:.3e}: fell {first / rec:.1f}-fold, at least 10 required) | a second run's residual history "
        f"and x equal in their bits | {st['loop_ms'] / 200:.4f} ms per iteration")

    from scipy.sparse.csgraph import shortest_path

    st = {}
    dist, ecc = on_path("examples/bfs_torch.bfs (ell_spmv, K2 at k=1)",
                       lambda: example("bfs_torch").bfs(A, 0, stats=st))
    ref_d = shortest_path(S, method="D", unweighted=True, indices=0)
    ref_d = np.where(np.isinf(ref_d), -1, ref_d).astype(np.int32)
    require(np.array_equal(dist, ref_d) and ecc == int(ref_d.max()),
            "bfs distances differ from scipy.sparse.csgraph's")
    say(f"phase 7c bfs: source 0 reaches {int((dist >= 0).sum())} of {n} nodes in {ecc} levels, equal to "
        f"scipy.sparse.csgraph | {st['loop_ms'] / st['levels']:.4f} ms per level (one scalar read each)")

    # triangle counting materialises A×A: between the neighbours of a hub of
    # degree d that is d**2 output entries (web-Google's symmetrised hubs:
    # 345,506, so 1.2e11), which neither the port nor scipy's masked product
    # can hold.  TRI_N keeps the product and its scipy reference within a
    # minute of this script's time (probe_backward.py times the sizes)
    tri = example("triangle_count_torch")
    U = tri.symmetrize(webgraph_like(TRI_N, 6 * TRI_N, seed=0))
    st = {}
    count, t_tri = timed(lambda: tri.count_triangles(U, stats=st))
    Su = U.to_scipy()
    ref_t = float((Su @ Su).multiply(Su).sum()) / 6.0
    require(count == ref_t and count > 0, f"triangle count {count} differs from scipy's {ref_t}")
    say(f"phase 7c triangle_count: {U.nrow} nodes, {U.nnz // 2} edges, {count:.0f} triangles, equal to scipy's "
        f"masked product | {t_tri:.1f} ms: ops.spgemm with its copy to the host {st['spgemm_ms']:.1f} "
        f"({st['out_nnz']} nnz), host join {st['join_ms']:.1f}")
    say(f"phase 7 launches on its path (timing and profiling repeats left out): {tally} | phase 7 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return tally


def dist_halo_plan_big(torch, A, S, ref_C, mesh, dev, paths, tally) -> str:
    """Phase 8a's second half: the halo, plan / exec / revalue and
    big-path entry points at world size 1 on NCCL, each held exact against
    scipy's A×A (the revalue in value mode within 1e-4 of max), timed
    (CUDA events around calls that synchronise, mean of 3) beside the
    single-chip call it mirrors; ``all_to_all_single`` counted around each
    call; then ``dryrun_multichip(1)`` with its K2 launches counted.
    Returns the phase's line."""
    import torch.distributed as dist

    from spmm_tpu_torch import ops
    from spmm_tpu_torch.entry import dryrun_multichip
    from spmm_tpu_torch.ops import slab_spgemm as ss
    from spmm_tpu_torch.parallel import (
        partition_rows, spgemm_dist_big, spgemm_dist_exec, spgemm_dist_halo,
        spgemm_dist_halo_exchange, spgemm_dist_plan, spgemm_dist_revalue,
    )

    spmm_mod = importlib.import_module("spmm_tpu_torch.ops.spmm")  # the module, not ops.spmm
    a2a, real_a2a = [0], dist.all_to_all_single

    def counted(*a, **k):
        a2a[0] += 1
        return real_a2a(*a, **k)

    def exchanges(fn):
        """(fn(), the all_to_all_single calls it made)."""
        n0 = a2a[0]
        out = fn()
        return out, a2a[0] - n0

    dist.all_to_all_single = counted
    try:
        C, n_h = exchanges(lambda: traced(paths, "parallel.spgemm_dist_halo",
                                          lambda: spgemm_dist_halo(S, A, mesh), tally))
        held_against(C, ref_C, "spgemm_dist_halo")
        C, n_hx = exchanges(lambda: traced(paths, "parallel.spgemm_dist_halo_exchange",
                                           lambda: spgemm_dist_halo_exchange(S, A, mesh), tally))
        held_against(C, ref_C, "spgemm_dist_halo_exchange")
        require(n_h == 0 and n_hx >= 1, f"all_to_all_single calls: halo {n_h}, halo exchange {n_hx}")
        plans, n_plan, n_exec, t_plan = {}, {}, {}, {}
        for bs in (False, True):
            (plans[bs], n_plan[bs]), t_plan[bs] = host_timed(torch, lambda: exchanges(
                lambda: launched(paths, "parallel.spgemm_dist_plan",
                                 lambda: spgemm_dist_plan(S, A, mesh, b_sharded=bs), {"slab_fetch": 1}, tally)))
            n_exec[bs] = 0
            for _ in range(2):
                C, n = exchanges(lambda: traced(paths, "parallel.spgemm_dist_exec",
                                                lambda: spgemm_dist_exec(plans[bs], mesh), tally))
                held_against(C, ref_C, f"spgemm_dist_exec (b_sharded={bs})")
                n_exec[bs] += n
        require(n_plan[False] == 0 and n_plan[True] >= 1 and n_exec == {False: 0, True: 0},
                f"all_to_all_single calls: plan {n_plan}, exec {n_exec}")
        # F1: the all-ones plans revalued with seeded normal values
        Av = dataclasses.replace(A, data=np.random.default_rng(91).standard_normal(
            np.asarray(A.data).shape[0]).astype(np.float32))
        Sv = partition_rows(Av, 1)
        ref_v, t_ref_v = host_timed(torch, lambda: scipy_square(Av.to_scipy()))
        err_v, t_rev = {}, {}
        for bs in (False, True):
            require(plans[bs].pattern, "the plan of A's all-ones values is not in pattern mode")
            pv, t_rev[bs] = host_timed(torch, lambda: launched(
                paths, "parallel.spgemm_dist_revalue", lambda: spgemm_dist_revalue(plans[bs], Sv, Av, mesh),
                {"slab_fetch": 1}, tally))
            require(not pv.pattern, "the revalued plan stayed in pattern mode (F1)")
            Cv = traced(paths, "parallel.spgemm_dist_exec", lambda: spgemm_dist_exec(pv, mesh), tally)
            err_v[bs] = held_against(Cv, ref_v, f"spgemm_dist_revalue (b_sharded={bs})", rtol=1e-4)
            del pv, Cv
        for bs in (False, True):
            C = traced(paths, "parallel.spgemm_dist_big",
                       lambda: spgemm_dist_big(A, A, mesh, pieces=2, b_sharded=bs), tally)
            held_against(C, ref_C, f"spgemm_dist_big (b_sharded={bs})")
        del C
        gm = {
            "halo": cuda_ms(torch, lambda: spgemm_dist_halo(S, A, mesh), iters=3, warmup=1),
            "halo_exchange": cuda_ms(torch, lambda: spgemm_dist_halo_exchange(S, A, mesh), iters=3,
                                     warmup=1),
            "exec": cuda_ms(torch, lambda: spgemm_dist_exec(plans[False], mesh), iters=3, warmup=1),
            "exec b_sharded": cuda_ms(torch, lambda: spgemm_dist_exec(plans[True], mesh), iters=3,
                                      warmup=1),
            # the plan reuse of two calls on the same operands (the first builds it)
            "ops.spgemm warm": cuda_ms(torch, lambda: ops.spgemm(A, A), iters=3, warmup=2),
            "big": cuda_ms(torch, lambda: spgemm_dist_big(A, A, mesh, pieces=2), iters=3, warmup=1),
            "big b_sharded": cuda_ms(torch, lambda: spgemm_dist_big(A, A, mesh, pieces=2, b_sharded=True),
                                     iters=3, warmup=1),
            "spgemm_slab_big": cuda_ms(torch, lambda: ss.spgemm_slab_big(A, A, pieces=2, device=dev),
                                       iters=3, warmup=1),
        }
        del plans
        # the dryrun's tiny ring products take K2's route with the pack
        # threshold at 0, as a full-size shard's do above it
        thr = spmm_mod.AUTO_ELL_THRESHOLD
        spmm_mod.AUTO_ELL_THRESHOLD = 0
        try:
            before = counters()["ell_slab_spmm"]
            _, t_dry = host_timed(torch, lambda: traced(paths, "entry.dryrun_multichip",
                                                        lambda: dryrun_multichip(1), tally))
            k2_dry = counters()["ell_slab_spmm"] - before
        finally:
            spmm_mod.AUTO_ELL_THRESHOLD = thr
        require(k2_dry >= 2, f"dryrun_multichip(1) launched K2 {k2_dry} times, expected >= 2")
    finally:
        dist.all_to_all_single = real_a2a
    return (f"phase 8a halo / plan / big (A×A exact against scipy from every entry point; "
            f"all_to_all_single calls: halo {n_h}, halo exchange {n_hx}, plan {n_plan[False]} / b_sharded "
            f"{n_plan[True]}, 2 execs {n_exec[False]} / {n_exec[True]}): halo {gm['halo']:.1f} ms, halo "
            f"exchange {gm['halo_exchange']:.1f} | plan build {t_plan[False]:.1f} / b_sharded "
            f"{t_plan[True]:.1f} ms (host, first call), exec {gm['exec']:.1f} / b_sharded "
            f"{gm['exec b_sharded']:.1f} vs ops.spgemm warm (plan reuse) {gm['ops.spgemm warm']:.1f} | "
            f"revalue of the all-ones plans to normal values (F1) {t_rev[False]:.1f} / {t_rev[True]:.1f} ms "
            f"(host), max_abs_err {err_v[False]:.3e} / {err_v[True]:.3e} (tol 1e-4 of max {float(np.abs(ref_v.data).max()):.3e}; "
            f"scipy {t_ref_v:.1f} ms) | big pieces=2 {gm['big']:.1f} / b_sharded {gm['big b_sharded']:.1f} vs "
            f"spgemm_slab_big(pieces=2) {gm['spgemm_slab_big']:.1f} (CUDA events around calls that "
            f"synchronise, mean of 3) | dryrun_multichip(1) {t_dry:.1f} ms (host), {k2_dry} K2 launches "
            f"(pack threshold 0 for its tiny shapes)")


#: the graph of phase 8b (four gloo ranks on the host's CPUs): web-Google's
#: mean degree on 65,536 nodes, with k = 32
GLOO_N, GLOO_NNZ, GLOO_K = 65_536, 365_000, 32


def dist_phase(torch, A, ref_C, dev, rng, paths, root) -> dict:
    """Phase 8, the distribution layer.  (a) On the card at full size: NCCL
    at world size 1 on ``dev`` (the collectives degenerate, the kernels and
    their launches are real); every distributed entry point held against
    scipy and against the single-chip call it wraps, each K2 launch counted
    around the path's own calls, and timed (CUDA events) beside that call.
    (b) Four gloo ranks on the host's CPUs (the tests' rank pool,
    ``tests/torch_dist.py``) on a cut graph: the collective logic under this
    machine's torch, against scipy; a host run of the plain versions.
    Returns each kernel's launches on (a)'s path."""
    import dataclasses as dc

    import torch.distributed as dist

    from spmm_tpu_torch import ops
    from spmm_tpu_torch.formats import webgraph_like
    from spmm_tpu_torch.formats.containers import as_numpy
    from spmm_tpu_torch.ops import slab_spgemm as ss
    from spmm_tpu_torch.parallel import (
        make_mesh, partition_cols, partition_rows, spgemm_dist_csr, spgemm_dist_spmd, spmm_dist,
        spmm_dist_colsplit, spmm_dist_ring, spmv_dist, unshard_csr_rows, unshard_rows,
    )
    from spmm_tpu_torch.parallel.mesh import free_port

    t_phase = time.perf_counter()
    tally = dict.fromkeys(counters(), 0)

    # ---- (a) NCCL, world size 1, full size --------------------------------
    port = free_port()
    card = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(card)  # the rank's device, before the mesh's communicator
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
                            device_id=card)
    try:
        mesh = make_mesh()
        require(str(dist.get_backend()) == "nccl" and mesh.device_type == "cuda",
                f"phase 8 runs on NCCL over the card, not {dist.get_backend()} / {mesh.device_type}")
        (S, Sc), t_part = host_timed(torch, lambda: (partition_rows(A, 1), partition_cols(A, 1)))
        k = 128
        B = torch.from_numpy(rng.standard_normal((A.ncol, k)).astype(np.float32)).to(dev)
        x = B[:, 0].contiguous()
        Bh = B.cpu().numpy()
        ref = A.to_scipy() @ Bh
        ref_x = ref[:, 0]
        m = A.nrow
        cases = [  # name, distributed call, its (m, k) result, single-chip call, scipy
            ("spmm_dist", lambda: spmm_dist(S, B, mesh), lambda y: unshard_rows(y, S),
             lambda: ops.spmm(A, B), ref),
            ("spmm_dist_ring", lambda: spmm_dist_ring(S, B, mesh), lambda y: unshard_rows(y, S),
             lambda: ops.spmm(A, B), ref),
            ("spmm_dist_colsplit", lambda: spmm_dist_colsplit(Sc, B, mesh),
             lambda y: y.reshape(-1, k)[:m], lambda: ops.spmm(A, B), ref),
            ("spmv_dist", lambda: spmv_dist(S, x, mesh), lambda y: unshard_rows(y[..., None], S)[:, 0],
             lambda: ops.spmv(A, x), ref_x),
        ]
        rows = []
        for name, call, flat, single, sref in cases:
            y = launched(paths, f"parallel.{name}", call, {"ell_slab_spmm": 1}, tally)
            require(y.is_cuda, f"{name}: the result is not on the card")
            y1 = single().cpu().numpy()
            yf = as_numpy(flat(y))
            err_s = float(np.abs(yf - sref).max())
            require(err_s <= 1e-4 * float(np.abs(sref).max()), f"{name} differs from scipy: {err_s:.3e}")
            rel_1 = float(np.abs(yf - y1).max()) / max(float(np.abs(y1).max()), 1e-30)
            require(rel_1 <= 1e-5, f"{name} differs from the single-chip call: rel {rel_1:.3e}")
            ms_d = cuda_ms(torch, call)
            ms_1 = cuda_ms(torch, single)
            ms_d2 = cuda_ms(torch, call)
            rows.append(f"{name} {ms_d:.4f} / {ms_d2:.4f} ms vs single-chip {ms_1:.4f} "
                        f"(err vs scipy {err_s:.2e}, vs single {rel_1:.1e})")
            del y, y1, yf
        say(f"phase 8a NCCL world size 1 on {torch.cuda.get_device_name(0)}, webgraph {A.shape} nnz {A.nnz}, "
            f"k={k} (partition_rows + partition_cols {t_part:.1f} ms host); CUDA events, mean of 10, "
            f"distributed call timed twice around the single-chip one: " + " | ".join(rows))
        del B, x, ref

        # A×A: the global host CSR and the row-sharded device CSR
        C = traced(paths, "parallel.spgemm_dist_spmd", lambda: spgemm_dist_spmd(S, A, mesh), tally)
        held_against(C, ref_C, "spgemm_dist_spmd")
        G = traced(paths, "parallel.spgemm_dist_csr", lambda: spgemm_dist_csr(S, A, mesh), tally)
        require(G.data.is_cuda and G.nnz == ref_C.nnz, "spgemm_dist_csr: not on the card, or nnz differs")
        held_against(unshard_csr_rows(G), ref_C, "spgemm_dist_csr")
        del C, G
        fresh = lambda: dc.replace(A)  # a new operand object: no plan reuse in ops.spgemm
        gm = {
            "spgemm_dist_spmd": cuda_ms(torch, lambda: spgemm_dist_spmd(S, A, mesh), iters=3, warmup=1),
            "ops.spgemm": cuda_ms(torch, lambda: ops.spgemm(fresh(), A), iters=3, warmup=1),
            "spgemm_dist_csr": cuda_ms(torch, lambda: spgemm_dist_csr(S, A, mesh), iters=3, warmup=1),
            "spgemm_slab_csr": cuda_ms(torch, lambda: ss.spgemm_slab_csr(A, A, device=dev), iters=3,
                                       warmup=1),
        }
        say(f"phase 8a A×A ({ref_C.nnz} nnz, structure equal to scipy's, counts exact): "
            f"spgemm_dist_spmd {gm['spgemm_dist_spmd']:.1f} ms vs ops.spgemm (no plan) {gm['ops.spgemm']:.1f} | "
            f"spgemm_dist_csr {gm['spgemm_dist_csr']:.1f} ms vs spgemm_slab_csr {gm['spgemm_slab_csr']:.1f} "
            f"(CUDA events around calls that synchronise, mean of 3) | launches on the path {tally}")
        say(dist_halo_plan_big(torch, A, S, ref_C, mesh, dev, paths, tally))
        say(f"phase 8a launches on the path {tally}")
    finally:
        dist.destroy_process_group()

    # ---- (b) four gloo ranks on the host ----------------------------------
    sys.path.insert(0, os.path.join(root, "tests"))
    import torch_dist

    t0 = time.perf_counter()
    Ag = webgraph_like(GLOO_N, GLOO_NNZ, seed=0)
    Bg = rng.standard_normal((GLOO_N, GLOO_K)).astype(np.float32)
    refg = Ag.to_scipy() @ Bg
    refCg = scipy_square(Ag.to_scipy())
    nr = torch_dist.RANKS
    Sg, Scg = partition_rows(Ag, nr), partition_cols(Ag, nr)
    pool = torch_dist.RankPool(nr)
    try:
        host = {}
        for name, Sx, Bx, flat, want in (
            ("spmm_dist", Sg, Bg, lambda y: unshard_rows(y, Sg), refg),
            ("spmm_dist_ring", Sg, Bg, lambda y: unshard_rows(y, Sg), refg),
            ("spmm_dist_colsplit", Scg, Bg, lambda y: y.reshape(-1, GLOO_K)[:GLOO_N], refg),
            ("spmv_dist", Sg, np.ascontiguousarray(Bg[:, 0]), lambda y: unshard_rows(y[..., None], Sg)[:, 0],
             refg[:, 0]),
        ):
            outs = pool.run(torch_dist.spmm_task, name, Sx, Bx)
            y = flat(np.stack([o["block"][0] for o in outs]))
            err = float(np.abs(y - want).max())
            require(err <= 1e-4 * float(np.abs(want).max()), f"gloo {name} differs from scipy: {err:.3e}")
            host[name] = max(o["ms"] for o in outs)
        outs = pool.run(torch_dist.spgemm_task, Sg, Ag)
        for o in outs:
            held_against(o["C"], refCg, "gloo spgemm_dist_spmd")
        host["spgemm_dist_spmd"] = max(o["ms"] for o in outs)
        outs = pool.run(torch_dist.spgemm_csr_task, Sg, Ag)
        blocks = [o["block"] for o in outs]
        G = dc.replace(blocks[0], data=np.concatenate([b.data for b in blocks]),
                       indices=np.concatenate([b.indices for b in blocks]),
                       indptr=np.concatenate([b.indptr for b in blocks]))
        require(all(o["nnz"] == refCg.nnz for o in outs), "gloo spgemm_dist_csr: nnz differs")
        held_against(unshard_csr_rows(G), refCg, "gloo spgemm_dist_csr")
        host["spgemm_dist_csr"] = max(o["ms"] for o in outs)
        # the halo, plan / exec / revalue and big-path entry points
        for name in ("spgemm_dist_halo", "spgemm_dist_halo_exchange"):
            outs = pool.run(torch_dist.halo_task, name, Sg, Ag)
            for o in outs:
                held_against(o["C"], refCg, f"gloo {name}")
            require(all(len(o["a2a"]) == (name == "spgemm_dist_halo_exchange") for o in outs),
                    f"gloo {name}: all_to_all_single calls {[o['a2a'] for o in outs]}")
            host[name] = max(o["ms"] for o in outs)
        for bs in (False, True):
            outs = pool.run(torch_dist.plan_task, Sg, Ag, b_sharded=bs)
            for o in outs:
                for C in o["C"]:
                    held_against(C, refCg, f"gloo spgemm_dist_plan / exec (b_sharded={bs})")
                require(len(o["plan"]["a2a"]) == bs and not o["exec"]["a2a"],
                        f"gloo plan / exec: all_to_all_single calls {o['plan']['a2a']} / {o['exec']['a2a']}")
            tag = " b_sharded" if bs else ""
            host["spgemm_dist_plan" + tag] = max(o["ms"]["plan"] for o in outs)
            host["spgemm_dist_exec" + tag] = max(o["ms"]["exec"] for o in outs)
        Ag2 = dc.replace(Ag, data=rng.standard_normal(np.asarray(Ag.data).shape[0]).astype(np.float32))
        refCg2 = scipy_square(Ag2.to_scipy())
        for bs in (False, True):  # F1: an all-ones plan revalued with normal values
            outs = pool.run(torch_dist.revalue_task, Sg, Ag, partition_rows(Ag2, nr), Ag2, (Sg, Ag),
                            b_sharded=bs)
            for o in outs:
                require(o["patterns"] == (True, False), f"gloo revalue: pattern modes {o['patterns']}")
                held_against(o["C"], refCg2, f"gloo spgemm_dist_revalue (b_sharded={bs})", rtol=1e-4)
        for bs in (False, True):
            outs = pool.run(torch_dist.big_task, Ag, Ag, pieces=2, b_sharded=bs)
            for o in outs:
                held_against(o["C"], refCg, f"gloo spgemm_dist_big (b_sharded={bs})")
            host["spgemm_dist_big" + (" b_sharded" if bs else "")] = max(o["ms"] for o in outs)
        outs = pool.run(torch_dist.dryrun_task, nr, timeout=300)
        require(len(outs[0]["out"].splitlines()) == 10 and "mesh={'rows': 2, 'cols': 2}" in outs[0]["out"],
                f"gloo dryrun_multichip({nr}) printed: {outs[0]['out']!r}")
        env = pool.run(torch_dist.env_task)
        require(not any(e["jax"] for e in env), "a gloo rank loaded JAX")
    finally:
        pool.close()
    say(f"phase 8b {nr} gloo ranks on this host's CPUs (torch {torch.__version__}, one thread each; a host "
        f"run of the plain versions, no card): webgraph ({GLOO_N}, {GLOO_N}) nnz {Ag.nnz} (web-Google cut to "
        f"{GLOO_N} nodes at its mean degree), k={GLOO_K}, every entry point against scipy | host ms per call "
        f"(SpMM: the second of two calls, SpGEMM: its one call, exec: the second of two), slowest rank: "
        + " | ".join(f"{n_} {v:.1f}" for n_, v in host.items())
        + f" | dryrun_multichip({nr}) on a (2, 2) mesh: its 10 lines OK"
        + f" | phase 8b took {time.perf_counter() - t0:.1f} s, phase 8 {time.perf_counter() - t_phase:.1f} s")
    return tally


def rates_phase(torch, A, E, dev, rng, k2: dict, sg: dict) -> dict:
    """Phase 9: the committed primitive rates (``ops.roofline.MeasuredRates``)
    beside the probe run again here, and the attainable share (bound /
    measured time) of the main path's products: ``ell_spmm`` k=128 and K2 on
    the web-Google pack (phase 3's times), ``ell_spmv`` on the same pack
    (timed here), ``ops.spgemm`` cold, the warm numeric phase and the chain
    per product (phase 5's times).  Each share must be finite and above 0;
    above 1 it is read in PERF.md.  Returns each product's bound and share
    from this run's probe (the kernels line holds only this run's
    measurements) beside those from the file."""
    from spmm_tpu_torch import ops
    from spmm_tpu_torch.ops import slab_spgemm as ss
    from spmm_tpu_torch.ops.roofline import (
        MeasuredRates, spgemm_attainable, spgemm_warm_attainable, spmm_attainable, spmv_attainable,
    )
    from spmm_tpu_torch.utils.primitives import measure_rates

    t_phase = time.perf_counter()
    path = MeasuredRates.calibration_path()
    with open(path) as f:
        raw = json.load(f)
    name = torch.cuda.get_device_name(0)
    require(raw.get("_device") == name, f"{os.path.basename(path)} was measured on {raw.get('_device')!r}, "
            f"this run is on {name!r}")
    rates = MeasuredRates.parse(raw, path)
    probe = []
    fresh = MeasuredRates(**measure_rates(size_log2=22, device=dev, log=probe.append))
    for line in probe:
        say(f"phase 9 probe, size 2^22: {line}")

    def show(v):
        return ", ".join(f"{x:g}: {r:.4g}" for x, r in v) if isinstance(v, tuple) else f"{v:.4g}"

    say(f"phase 9 rates: the file ({raw['_power_limit']}, captured {raw['_captured']}, size 2^{raw['_size_log2']}, "
        f"torch {raw['_torch']} cuda {raw['_cuda']}) | this run's probe (not gated) | "
        + " | ".join(f"{f.name} {show(getattr(rates, f.name))} / {show(getattr(fresh, f.name))}"
                     for f in dataclasses.fields(MeasuredRates)))

    n, W = A.shape[0], ss.DEFAULT_SEG_W
    x = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    spmv_ms = cuda_ms(torch, lambda: ops.ell_spmv(E, x))
    sizing, out_nnz = sg["sizing"], sg["out_nnz"]
    cold_kw = ss.attainable_kwargs(sizing, n, out_nnz, ss._norm_classes(ss.DEFAULT_CLASSES, W), W=W)
    chunk_slots = cold_kw["chunk_slots"]
    spmm_bound = lambda r: spmm_attainable(E.padded_nnz, n, 128, r, table_bytes=n * 128 * 4)
    bounds = {  # name: (the bound as a function of the rates, measured ms, its arguments)
        "ell_spmm k=128": (spmm_bound, k2["ell_spmm_ms"],
                           f"spmm_attainable({E.padded_nnz}, {n}, 128, table_bytes={n * 512})"),
        "K2 k=128": (spmm_bound, k2["ms"], "the same bound over K2's time alone"),
        "ell_spmv": (lambda r: spmv_attainable(E.padded_nnz, r), spmv_ms, f"spmv_attainable({E.padded_nnz})"),
        "ops.spgemm cold": (lambda r: spgemm_attainable(sizing.npa, sizing.npa * W, A.nnz, None, r, **cold_kw),
                            sg["cold_ms"],
                            f"spgemm_attainable(npa={sizing.npa}, slots={sizing.npa * W}, nnz_b={A.nnz}, "
                            + ", ".join(f"{k}={v}" for k, v in cold_kw.items() if k != "chunk_slots")
                            + f", chunk_slots=<{len(chunk_slots)} chunks, {sum(s for _, s in chunk_slots)} slots>)"),
        "warm numeric": (lambda r: spgemm_warm_attainable(sizing.npa * W, out_nnz, r, chunk_slots=chunk_slots),
                         sg["warm_ms"], f"spgemm_warm_attainable({sizing.npa * W}, {out_nnz}, chunk_slots=...)"),
        "chain per product": (lambda r: spgemm_warm_attainable(sizing.npa * W, out_nnz, r, dispatches=1 / 8,
                                                               chunk_slots=chunk_slots),
                              sg["chain_ms"], "the same with dispatches=1/8"),
    }
    shares = {}
    for what, (bound, ms, args) in bounds.items():
        b, b_fresh = bound(rates) * 1e3, bound(fresh) * 1e3
        share = b / ms
        for s_ in (share, b_fresh / ms):
            require(math.isfinite(s_) and s_ > 0, f"the attainable share of {what} is {s_}")
        shares[what] = dict(attainable_ms=b_fresh, attainable_share=b_fresh / ms)
        say(f"phase 9 attainable {what}: {args} = {b:.4f} ms (this run's rates {b_fresh:.4f}) | measured "
            f"{ms:.4f} ms | share {share:.3f} (this run's rates {b_fresh / ms:.3f})")
    say(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return shares


def bench_phase(torch, root) -> None:
    """Phase 10: ``bench_torch.py --quick --no-scaling`` in a subprocess on
    this card (``BENCH_BUDGET_S=400``: its gates ask for up to 200 s left
    before a section starts), its line held to the checks of the
    docstring; prints its main numbers and each section's seconds."""
    import bench_torch
    from spmm_tpu_torch.formats import webgraph_like

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.join(root, "bench_torch.py"), "--quick", "--no-scaling"],
                          cwd=root, env=dict(os.environ, BENCH_BUDGET_S="400"), capture_output=True,
                          text=True, timeout=600)
    t_run = time.perf_counter() - t_phase
    sections = " | ".join(ln.removeprefix("section ") for ln in proc.stderr.splitlines()
                          if ln.startswith("section "))
    require(proc.returncode == 0, f"bench_torch.py exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"bench_torch.py's last line is no JSON: {lines[-1:]!r}")
    value = res.get("value")
    require(isinstance(value, (int, float)) and value > 0, f"bench_torch.py's value is {value!r}")
    bad = [k for k in res if k in ("error", "interrupted", "skipped") or k.endswith("_error")]
    require(not bad, f"bench_torch.py's line holds {', '.join(f'{k}={res[k]!r}' for k in bad)}")
    for key in ("spgemm_ms", "spgemm_plan_ms", "spgemm_warm_ms", "spgemm_chain_ms", "spmm_ell_k128_ms",
                "spmv_ell_ms", "bsr_spmm_k128_ms", "spmm_ell_k32_ms", "spmm_blocked_k128_ms"):
        require(key in res, f"bench_torch.py's line has no {key}")
    for k, v in res.items():
        ok = isinstance(v, (int, float)) and math.isfinite(v)
        if k.endswith("_ms"):
            require(ok and v > 0, f"bench_torch.py's {k} is {v!r}")
        elif k.endswith("_sol_frac"):
            require(ok and 0 < v <= 1.05, f"bench_torch.py's {k} is {v!r}, not in (0, 1.05]")
        elif k.endswith("_att_frac"):
            require(ok and v > 0, f"bench_torch.py's {k} is {v!r}")
    A = webgraph_like(bench_torch.QUICK_N, bench_torch.QUICK_NNZ, seed=0)
    ref_nnz = scipy_square(A.to_scipy()).nnz
    require(res.get("spgemm_out_nnz") == ref_nnz,
            f"bench_torch.py's spgemm_out_nnz {res.get('spgemm_out_nnz')} is not scipy's {ref_nnz}")
    name = torch.cuda.get_device_name(0)
    require(res.get("device") == name, f"bench_torch.py ran on {res.get('device')!r}, not {name!r}")
    main_keys = ("value", "spgemm_ms", "spgemm_att_frac", "spgemm_plan_ms", "spgemm_warm_ms", "spgemm_chain_ms",
                 "spgemm_chain_att_frac", "spmm_ell_k128_ms", "spmm_ell_k128_sol_frac", "spmv_ell_ms",
                 "bsr_spmm_k128_ms", "spmm_ell_k32_ms", "spmm_blocked_k128_ms", "power_limit")
    say(f"phase 10 bench_torch.py --quick --no-scaling ({A.shape[0]} nodes, {A.nnz} nnz; A×A {ref_nnz} nnz, "
        f"scipy's): " + ", ".join(f"{k} {res.get(k)}" for k in main_keys)
        + f" | sections: {sections} | the run {t_run:.1f} s, phase 10 {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs the port on an NVIDIA GPU only")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import spmm_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the spmm_tpu_torch package is not beside this script ({e})")
    from spmm_tpu_torch import cli, kernels, native, ops
    from spmm_tpu_torch.formats import (
        banded_random, csr_to_bsr, ell_pack, to_coo, webgraph_like, write_mtx,
    )
    from spmm_tpu_torch.native.build import build as build_native
    from spmm_tpu_torch.ops import bsr_kernel, ell_kernel, slab_kernel
    from spmm_tpu_torch.ops.ell_spmm import slab_row_keys
    from spmm_tpu_torch.ops import segments
    from spmm_tpu_torch.ops.roofline import Roofline, detect_chip
    from spmm_tpu_torch.ops.transform import row_sums, scale_rows, transpose
    from spmm_tpu_torch.utils.profiling import profile_fn

    # the plain versions use batched matmuls: full fp32, as the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"phase 1 device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"count {torch.cuda.device_count()} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.lib()
    t_kernels = time.perf_counter() - t0
    t0 = time.perf_counter()
    require(build_native(force=True) is not None, "native host library: no sources or no g++")
    require(native.available(), "native host library did not load")
    t_native = time.perf_counter() - t0
    nvcc_v = subprocess.run([kernels.nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    say(f"phase 2 build: kernels {t_kernels * 1e3:.1f} ms ({', '.join(os.path.relpath(s, root) for s in kernels.sources())}) | "
        f"native {t_native * 1e3:.1f} ms | {nvcc_v.stdout.strip().splitlines()[-1]}")

    rng = np.random.default_rng(0)
    results = {}

    # ---- 3. kernels against their plain versions ---------------------------
    chip = detect_chip(dev)  # the H100's datasheet rates (ops/roofline.py)
    FP32_FLOPS, TF32_FLOPS, BF16_FLOPS, FP64_FLOPS, FP64_TC_FLOPS = (
        chip.flops_f32, chip.flops_tf32, chip.flops_bf16, chip.flops_f64, chip.flops_f64_tensor)

    def bound(nbytes: float, ops_: float, peak: float):
        """The least time (ms) for the work: bytes at the HBM rate or
        operations at the type's peak, whichever is larger, and which."""
        roof = Roofline(flops=ops_, hbm_bytes=nbytes, chip=chip, peak_flops=peak)
        return roof.t_sol_s * 1e3, roof.bound_by

    def csr_tensor(A, dtype=np.float32):
        """A host CSR as a CUDA ``torch.sparse_csr_tensor``: the library
        yardstick's operand, never used by the port."""
        t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
        return torch.sparse_csr_tensor(t(A.indptr, np.int64), t(A.indices[: A.nnz], np.int64),
                                       t(A.data[: A.nnz], dtype), size=A.shape)

    def entry(err, rel, ms, plain, b, lib, library, **extra):
        return dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain, bound_ms=b[0],
                    bound_by=b[1], library_ms=lib, library=library, **extra)

    t0 = time.perf_counter()
    A_band = banded_random(65536, 512, 0.25, seed=3)
    Ab = csr_to_bsr(A_band).to(dev)
    B_band = torch.from_numpy(rng.standard_normal((A_band.shape[1], 128)).astype(np.float32)).to(dev)
    # PyTorch's BSR product refuses non-square (8, 128) blocks on CUDA (an
    # internal assert, torch 2.11), so K1's yardstick is cuSPARSE's CSR SpMM
    # on the same matrix's 7.4M true nonzeros
    S_band = csr_tensor(A_band)
    say(f"phase 3 setup: BSR {A_band.shape} nnz {A_band.nnz} blocks {Ab.nblocks} "
        f"({(time.perf_counter() - t0) * 1e3:.1f} ms host)")
    bm, bn = Ab.block_shape
    for name, A_, B_, rtol in (
        ("fp32", Ab, B_band, RTOL_F32),
        ("bf16", dataclasses.replace(Ab, data=Ab.data.bfloat16()), B_band.bfloat16(), RTOL_BF16),
        # the mixes the reference takes, with no cast of the blocks (the bf16
        # values are widened alike in the plain version)
        ("fp32 blocks × bf16 B", Ab, B_band.bfloat16(), RTOL_F32),
        ("bf16 blocks × fp32 B", dataclasses.replace(Ab, data=Ab.data.bfloat16()), B_band, RTOL_F32),
    ):
        y = ops.spmm(A_, B_)
        ref = bsr_kernel.bsr_spmm_reference(A_, B_)
        torch.cuda.synchronize()
        err, rel = max_errs(y, ref)
        require(rel <= rtol, f"K1 {name} differs from its plain version: rel {rel:.3e}")
        ms = cuda_ms(torch, lambda: ops.spmm(A_, B_))
        plain = cuda_ms(torch, lambda: bsr_kernel.bsr_spmm_reference(A_, B_))
        flops = 2 * Ab.nblocks * bm * bn * 128
        nbytes = A_.data.numel() * A_.data.element_size() + B_.numel() * B_.element_size() + y.numel() * 4
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS if name == "bf16" else FP32_FLOPS)
        fma_ms = flops / FP32_FLOPS * 1e3  # the kernel's unit: fp32 FMA on the CUDA cores
        line = (f"phase 3 K1 bsr_spmm {name} k=128: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                f"(tol {rtol:g}) | kernel {ms:.4f} ms | plain {plain:.4f} ms | bound {b_ms:.4f} ms "
                f"({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), share {b_ms / ms:.1%} | "
                f"fp32-FMA bound {fma_ms:.4f} ms, share {fma_ms / ms:.1%}")
        if name == "fp32":
            # fp32-accurate on the tensor cores: three tf32 products (3xTF32 split)
            tc_ms, tc_by = bound(nbytes, 3 * flops, TF32_FLOPS)
            lib = cuda_ms(torch, lambda: torch.sparse.mm(S_band, B_))
            results["bsr_spmm"] = dict(
                max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, library="torch.sparse.mm(sparse_csr_tensor) (cuSPARSE CSR SpMM)")
            line += (f" | 3xTF32 tensor-core bound {tc_ms:.4f} ms ({tc_by}), share {tc_ms / ms:.1%} | "
                     f"library torch.sparse.mm on the CSR {lib:.4f} ms | before the redesign "
                     f"{PRIOR_MS['K1 fp32']} ms (PERF.md)")
        say(line)
    del S_band

    # K1 in fp64: the same kernel with double sums.  Its bound is at the
    # card's fp64 peak for a dense block product, the tensor cores' (DMMA is
    # exact fp64); the FMA rate of the CUDA cores, the kernel's unit, beside it
    Ab64 = dataclasses.replace(Ab, data=Ab.data.double())
    B64 = B_band.double()
    S_band64 = csr_tensor(A_band, np.float64)
    y = ops.spmm(Ab64, B64)
    ref = bsr_kernel.bsr_spmm_reference(Ab64, B64)
    torch.cuda.synchronize()
    err, rel = max_errs(y, ref)
    require(y.dtype == torch.float64 and rel <= RTOL_F64, f"K1 fp64 differs from its plain version: rel {rel:.3e}")
    ms = cuda_ms(torch, lambda: ops.spmm(Ab64, B64))
    plain = cuda_ms(torch, lambda: bsr_kernel.bsr_spmm_reference(Ab64, B64), iters=3)
    lib = cuda_ms(torch, lambda: torch.sparse.mm(S_band64, B64))
    nbytes64 = 8 * (Ab64.data.numel() + B64.numel() + y.numel())
    b64 = bound(nbytes64, flops, FP64_TC_FLOPS)
    fma64_ms = flops / FP64_FLOPS * 1e3
    results["bsr_spmm"]["fp64"] = entry(err, rel, ms, plain, b64, lib, "torch.sparse.mm fp64 (cuSPARSE CSR SpMM)")
    say(f"phase 3 K1 bsr_spmm fp64 k=128: max_abs_err {err:.3e} max_rel_err {rel:.3e} (tol {RTOL_F64:g}) | "
        f"kernel {ms:.4f} ms | plain {plain:.4f} ms | bound {b64[0]:.4f} ms ({b64[1]}; {flops / 1e9:.2f} GFLOP "
        f"at the tensor cores' fp64 peak, {nbytes64 / 1e6:.1f} MB), share {b64[0] / ms:.1%} | fp64-FMA bound "
        f"{fma64_ms:.4f} ms, share {fma64_ms / ms:.1%} | library torch.sparse.mm fp64 on the CSR {lib:.4f} ms")
    del Ab64, B64, S_band64, y, ref

    # K1's transposed kernel: grad B = Aᵀ · dY from A's own blocks, read in place
    dY_band = torch.from_numpy(rng.standard_normal((A_band.shape[0], 128)).astype(np.float32)).to(dev)
    _, t_T = host_timed(torch, lambda: bsr_kernel._device_transposed_plan(Ab, dev))
    S_band_T = csr_tensor(transpose(A_band))
    g = bsr_kernel.bsr_spmm_transposed(Ab, dY_band)
    ref = bsr_kernel.bsr_spmm_transposed_reference(Ab, dY_band)
    torch.cuda.synchronize()
    err, rel = max_errs(g, ref)
    require(rel <= RTOL_F32, f"K1's transposed kernel differs from its plain version: rel {rel:.3e}")
    _, rel_lib = max_errs(g, torch.sparse.mm(S_band_T, dY_band))
    require(rel_lib <= 1e-4, f"K1's transposed kernel differs from cuSPARSE on Aᵀ: {rel_lib:.3e}")
    ms_t = {}
    for turn in ("library", "kernel", "kernel", "library"):  # in turns, one card
        fn = ((lambda: torch.sparse.mm(S_band_T, dY_band)) if turn == "library"
              else (lambda: bsr_kernel.bsr_spmm_transposed(Ab, dY_band)))
        ms_t.setdefault(turn, []).append(cuda_ms(torch, fn))
    ms, lib = min(ms_t["kernel"]), min(ms_t["library"])
    plain = cuda_ms(torch, lambda: bsr_kernel.bsr_spmm_transposed_reference(Ab, dY_band), iters=3)
    flops_T = 2 * Ab.nblocks * bm * bn * 128
    bT = bound(4 * (Ab.nblocks * bm * bn + dY_band.numel() + g.numel()), flops_T, FP32_FLOPS)
    results["bsr_spmm_transposed"] = entry(err, rel, ms, plain, bT, lib,
                                           "torch.sparse.mm on the transposed CSR (cuSPARSE)")
    say(f"phase 3 K1 transposed kernel fp32 k=128 (grad B; A's {Ab.nblocks} blocks read in place, "
        f"plan built once in {t_T:.1f} ms host): max_rel_err {rel:.3e} (tol {RTOL_F32:g}), vs cuSPARSE "
        f"{rel_lib:.3e} | kernel {ms:.4f} ms (turns {', '.join(f'{t:.4f}' for t in ms_t['kernel'])}) | plain "
        f"{plain:.4f} ms | bound {bT[0]:.4f} ms ({bT[1]}; {flops_T / 1e9:.2f} GFLOP), share {bT[0] / ms:.1%} | "
        f"library torch.sparse.mm on the transposed CSR {lib:.4f} ms (turns "
        f"{', '.join(f'{t:.4f}' for t in ms_t['library'])}): kernel / library {ms / lib:.3f} | the route it "
        f"replaced (re-blocked Aᵀ, value gather + K1) {PRIOR_MS['K1 on Aᵀ']} ms (PERF.md)")
    # K1's value gradient: one torch.bmm over gathered tiles (a library product, by design)
    gd = bsr_kernel.bsr_data_grad(Ab, dY_band, B_band)
    blocks = rng.choice(Ab.nblocks, 64, replace=False)
    br, bc = Ab.block_rows[blocks].cpu().numpy(), Ab.block_cols[blocks].cpu().numpy()
    dYh, Bh = dY_band.cpu().numpy().astype(np.float64), B_band.cpu().numpy().astype(np.float64)
    want = np.stack([dYh[r * bm:(r + 1) * bm] @ Bh[c * bn:(c + 1) * bn].T for r, c in zip(br, bc)])
    err_gd = float(np.abs(gd[blocks].cpu().numpy() - want).max())
    require(err_gd <= 1e-5 * float(np.abs(want).max()), f"bsr_data_grad differs from numpy fp64: {err_gd:.3e}")
    ms_gd = cuda_ms(torch, lambda: bsr_kernel.bsr_data_grad(Ab, dY_band, B_band))
    b_gd = bound(4 * (dY_band.numel() + B_band.numel() + gd.numel()), flops, FP32_FLOPS)
    results["bsr_spmm"]["data_grad_bmm"] = dict(ms=ms_gd, bound_ms=b_gd[0], bound_by=b_gd[1], max_abs_err=err_gd)
    say(f"phase 3 K1 value gradient (torch.bmm over gathered tiles, a library product) k=128: max_abs_err "
        f"{err_gd:.3e} on 64 blocks vs numpy fp64 | {ms_gd:.4f} ms | bound {b_gd[0]:.4f} ms ({b_gd[1]}), "
        f"share {b_gd[0] / ms_gd:.1%}")
    del S_band_T, g, ref, gd, dY_band, ms_t

    t0 = time.perf_counter()
    A_web = webgraph_like(WEB_N, WEB_NNZ, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    E = ell_pack(A_web).to(dev)
    t_pack = time.perf_counter() - t0
    S_web = csr_tensor(A_web)
    slots = sum(int(c.numel()) for c in E.cols)
    slab_rows = sum(int(c.shape[0]) for c in E.cols)
    distinct = int(torch.unique(torch.cat([c.flatten() for c in E.cols]).clamp(0, WEB_N - 1)).numel())
    say(f"phase 3 setup: webgraph {A_web.shape} nnz {A_web.nnz} ({t_gen * 1e3:.1f} ms host) | "
        f"ELL {len(E.data)} slabs, {slab_rows} slab rows, {slots} padded slots, {distinct} distinct "
        f"B rows, padded nnz {E.padded_nnz}, rest rows {E.n_rest_rows} ({t_pack * 1e3:.1f} ms pack)")
    keys = slab_row_keys(E)  # the work order ell_spmm gives K2
    for k in (128, 32):
        Bw = torch.from_numpy(rng.standard_normal((WEB_N, k)).astype(np.float32)).to(dev)
        memo = {}
        y = ell_kernel.ell_slabs_spmm(E.cols, E.data, Bw, memo=memo, row_keys=keys)
        ref = ell_kernel.ell_slabs_spmm_reference(E.cols, E.data, Bw, torch.empty_like(y))
        y_lib = torch.sparse.mm(S_web, Bw)
        torch.cuda.synchronize()
        err, rel = max_errs(y, ref)
        require(rel <= RTOL_F32, f"K2 k={k} differs from its plain version: rel {rel:.3e}")
        _, rel_lib = max_errs(ops.ell_spmm(E, Bw), y_lib)
        require(rel_lib <= 1e-4, f"the library yardstick computes another product at k={k}: {rel_lib:.3e}")
        ms = cuda_ms(torch, lambda: ell_kernel.ell_slabs_spmm(E.cols, E.data, Bw, y, memo=memo))
        plain = cuda_ms(torch, lambda: ell_kernel.ell_slabs_spmm_reference(E.cols, E.data, Bw, ref))
        whole = cuda_ms(torch, lambda: ops.ell_spmm(E, Bw))
        lib = cuda_ms(torch, lambda: torch.sparse.mm(S_web, Bw))
        nbytes = slots * (4 + E.data[0].element_size()) + distinct * k * 4 + slab_rows * k * 4
        b_ms, b_by = bound(nbytes, 2 * slots * k, FP32_FLOPS)
        prior = PRIOR_MS[f"K2 k={k}"]
        say(f"phase 3 K2 ell_slabs_spmm fp32 k={k} ({len(E.cols)} slabs, one launch): max_abs_err "
            f"{err:.3e} max_rel_err {rel:.3e} (tol {RTOL_F32:g}) | kernel {ms:.4f} ms | plain "
            f"{plain:.4f} ms | bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB), share {b_ms / ms:.1%} "
            f"| library torch.sparse.mm on the CSR {lib:.4f} ms beside K2 {ms:.4f} and the whole "
            f"ell_spmm {whole:.4f} | before the redesign {prior} ms (PERF.md)")
        if k == 128:
            results["ell_slab_spmm"] = dict(
                max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, library="torch.sparse.mm(sparse_csr_tensor) (cuSPARSE CSR SpMM)",
                ell_spmm_ms=whole)
        del Bw, y, ref, y_lib

    # K2 in fp64, K2 on the transposed pack (grad B), K3 (grad data), at k = 128 (and 32)
    perm_slab = torch.from_numpy(np.ascontiguousarray(keys)).to(dev).long()  # original row of each slab row
    E64d = tuple(d.double() for d in E.data)
    B64 = torch.from_numpy(rng.standard_normal((WEB_N, 128))).to(dev)
    S_web64 = csr_tensor(A_web, np.float64)
    memo64 = {}
    y = ell_kernel.ell_slabs_spmm(E.cols, E64d, B64, memo=memo64, row_keys=keys)
    ref = ell_kernel.ell_slabs_spmm_reference(E.cols, E64d, B64, torch.empty_like(y))
    torch.cuda.synchronize()
    err, rel = max_errs(y, ref)
    require(y.dtype == torch.float64 and rel <= RTOL_F64, f"K2 fp64 differs from its plain version: rel {rel:.3e}")
    ms = cuda_ms(torch, lambda: ell_kernel.ell_slabs_spmm(E.cols, E64d, B64, y, memo=memo64))
    plain = cuda_ms(torch, lambda: ell_kernel.ell_slabs_spmm_reference(E.cols, E64d, B64, ref), iters=3)
    lib = cuda_ms(torch, lambda: torch.sparse.mm(S_web64, B64))
    b64 = bound(slots * 12 + distinct * 128 * 8 + slab_rows * 128 * 8, 2 * slots * 128, FP64_FLOPS)
    results["ell_slab_spmm"]["fp64"] = entry(err, rel, ms, plain, b64, lib, "torch.sparse.mm fp64 (cuSPARSE CSR SpMM)")
    say(f"phase 3 K2 ell_slabs_spmm fp64 k=128: max_abs_err {err:.3e} max_rel_err {rel:.3e} (tol {RTOL_F64:g}) | "
        f"kernel {ms:.4f} ms | plain {plain:.4f} ms | bound {b64[0]:.4f} ms ({b64[1]}), share {b64[0] / ms:.1%} "
        f"| library torch.sparse.mm fp64 on the CSR {lib:.4f} ms")
    del E64d, B64, S_web64, memo64, y, ref

    # grad B of ell_spmm: K2 over the transposed pack with the forward's row
    # map (dY read at the original rows) and the value index (A's values read
    # where they are stored), each row of Aᵀ written at its row of the result
    memo = {}
    out_rows_w = perm_slab.to(torch.int32)
    T_web, t_T = host_timed(torch, lambda: ell_kernel.transposed_slabs(E.cols, WEB_N, dev, out_rows=out_rows_w))
    memo[("transposed", dev, WEB_N, "rows")] = T_web
    t_slots = sum(int(c.numel()) for c in T_web.cols)
    S_web_T = csr_tensor(transpose(A_web))
    say(f"phase 3 setup: transposed pack built in {t_T:.1f} ms (device sort + host slab plan): "
        f"{len(T_web.cols)} slabs, {T_web.rows} slab rows for {WEB_N} rows of Aᵀ, {t_slots} padded slots, "
        f"{int(T_web.hub_rows.numel())} rows cut into up to {T_web.hub_idx.shape[1]} pieces of "
        f"{ell_kernel.T_CUT} ({T_web.scratch} scratch rows), {int(T_web.empty_rows.numel())} empty rows")
    for k in (128, 32):
        dY = torch.from_numpy(rng.standard_normal((slab_rows, k)).astype(np.float32)).to(dev)
        # ell_spmm's output gradient: rows in the original order, zero where no slab row lies
        dY_full = torch.zeros((WEB_N, k), device=dev).index_copy_(0, perm_slab, dY)

        def route():
            return ell_kernel.ell_slabs_spmm_transposed(E.cols, E.data, dY_full, WEB_N, memo=memo,
                                                        out_rows=out_rows_w)

        before = counters()
        g = route()
        require(counters()["ell_slab_spmm_transposed"] - before["ell_slab_spmm_transposed"] == 1,
                f"the grad-B route k={k} is not one K2 launch")
        g2 = route()
        ref = ell_kernel.ell_slabs_spmm_transposed_reference(E.cols, E.data, dY_full, WEB_N, memo=memo,
                                                             out_rows=out_rows_w)
        g_lib = torch.sparse.mm(S_web_T, dY_full)
        torch.cuda.synchronize()
        require(torch.equal(g, g2), f"the grad-B route k={k}: two runs differ in their bits")
        err, rel = max_errs(g, ref)
        require(rel <= RTOL_F32, f"K2 on the transposed pack k={k} differs from its plain version: rel {rel:.3e}")
        _, rel_lib = max_errs(g, g_lib)
        require(rel_lib <= 1e-4, f"K2 on the transposed pack k={k} differs from cuSPARSE on Aᵀ: {rel_lib:.3e}")
        ms_t = {}
        for turn in ("library", "kernel", "kernel", "library"):  # in turns, one card
            fn = (lambda: torch.sparse.mm(S_web_T, dY_full)) if turn == "library" else route
            ms_t.setdefault(turn, []).append(cuda_ms(torch, fn))
        ms, lib = min(ms_t["kernel"]), min(ms_t["library"])
        plain = cuda_ms(torch, lambda: ell_kernel.ell_slabs_spmm_transposed_reference(
            E.cols, E.data, dY_full, WEB_N, memo=memo, out_rows=out_rows_w), iters=3)
        # each input once: the pack (cols, value index), A's values, the dY rows; the output
        nbytes_T = t_slots * 8 + slots * E.data[0].element_size() + slab_rows * k * 4 + WEB_N * k * 4
        bT = bound(nbytes_T, 2 * t_slots * k, FP32_FLOPS)
        prior = PRIOR_MS["K2 on Aᵀ" if k == 128 else "K2 on Aᵀ k=32"]
        say(f"phase 3 K2 on the transposed pack fp32 k={k} (one launch with the row map and the value "
            f"index; timed: value concatenation + K2 + empty-row fill + the cut rows' join): max_abs_err "
            f"{err:.3e} max_rel_err {rel:.3e} (tol {RTOL_F32:g}), vs cuSPARSE on Aᵀ {rel_lib:.3e}, two runs "
            f"bit-identical | route {ms:.4f} ms (turns {', '.join(f'{t:.4f}' for t in ms_t['kernel'])}) | "
            f"plain {plain:.4f} ms | bound {bT[0]:.4f} ms ({bT[1]}; {nbytes_T / 1e6:.1f} MB), share "
            f"{bT[0] / ms:.1%} | library torch.sparse.mm on the transposed CSR {lib:.4f} ms (turns "
            f"{', '.join(f'{t:.4f}' for t in ms_t['library'])}): route / library {ms / lib:.3f} | the "
            f"route it replaced (value gather + K2 + row gather + join) {prior} ms (PERF.md)")
        if k == 128:
            p = profile_fn(route, repeats=3, warm=False)
            say(f"phase 3 profile, grad-B route k=128 (device ms per call, busy {p.total_device_ms:.4f}): "
                + profile_line(p, 8))
        if k == 128:
            results["ell_slab_spmm_transposed"] = entry(err, rel, ms, plain, bT, lib,
                                                        "torch.sparse.mm on the transposed CSR (cuSPARSE)")
        del ms_t
        # K3 on the same dY, against the forward's B, in ell_spmm's work order
        Bw = torch.from_numpy(rng.standard_normal((WEB_N, k)).astype(np.float32)).to(dev)
        memo3 = {}
        k3 = lambda: ell_kernel.ell_slabs_sddmm(E.cols, dY, Bw, memo=memo3, row_keys=keys)
        out, out2 = k3(), k3()
        ref3 = ell_kernel.ell_slabs_sddmm_reference(E.cols, dY, Bw)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(out, out2)), f"K3 k={k}: two runs differ in their bits")
        scale = max(float(r_.abs().max()) for r_ in ref3)
        err = max(float((o - r_).abs().max()) for o, r_ in zip(out, ref3))
        require(err <= RTOL_F32 * scale, f"K3 k={k} differs from its plain version: rel {err / scale:.3e}")
        ms3 = cuda_ms(torch, k3)
        dev3, enq3 = device_and_enqueue(torch, k3)
        plain3 = cuda_ms(torch, lambda: ell_kernel.ell_slabs_sddmm_reference(E.cols, dY, Bw), iters=3)
        Bt = Bw.t()
        lib3 = cuda_ms(torch, lambda: torch.sparse.sampled_addmm(S_web, dY_full, Bt, beta=0.0))
        b3 = bound(slots * 8 + distinct * k * 4 + slab_rows * k * 4, 2 * slots * k, FP32_FLOPS)
        e3 = entry(err, err / scale, dev3, plain3, b3, lib3,
                   "torch.sparse.sampled_addmm on the CSR pattern (cuSPARSE SDDMM)", event_ms=ms3,
                   enqueue_us=enq3)
        if k == 128:
            results["ell_slab_sddmm"] = e3
        else:
            results["ell_slab_sddmm"]["k32"] = e3
        say(f"phase 3 K3 ell_slabs_sddmm fp32 k={k} ({len(E.cols)} slabs, one launch): max_abs_err {err:.3e} "
            f"max_rel_err {err / scale:.3e} (tol {RTOL_F32:g}), two runs bit-identical | kernel {ms3:.4f} ms "
            f"(profiler: device {dev3:.4f} ms per call, host enqueue {enq3:.1f} us per call) | plain "
            f"{plain3:.4f} ms | bound {b3[0]:.4f} ms ({b3[1]}), share of the device time {b3[0] / dev3:.1%} | library "
            f"torch.sparse.sampled_addmm {lib3:.4f} ms | before the redesign {PRIOR_MS[f'K3 k={k}']} ms (PERF.md)")
        del Bw, out, out2, ref3, Bt
        del dY, dY_full, g, g2, ref, g_lib
    del S_web, S_web_T, T_web, memo

    # the ordered segment sum (F6) on PageRank's leftover rows: Pᵀ's rows longer
    # than the pack's max_len, a few hubs holding a quarter of the entries, k = 1
    d = row_sums(A_web)
    P = scale_rows(A_web, np.where(d == 0, 0.0, 1.0 / np.maximum(d, 1e-30)))
    E_pt = ell_pack(transpose(P)).to(dev)
    rest = E_pt.rest
    x_pt = torch.from_numpy(rng.random(WEB_N).astype(np.float32)).to(dev)
    contrib = (x_pt[rest.indices.long()] * rest.data)[:, None].contiguous()
    seg_plan = importlib.import_module("spmm_tpu_torch.ops.spmm")._rows_plan(rest, dev)
    seg_ids = segments.boundary_segments(rest.indptr, rest.nnz_pad, dtype=torch.int64)
    nrest = E_pt.n_rest_rows
    r_seg = ordered_sum_shape(torch, segments, contrib, seg_plan, seg_ids, bound, FP32_FLOPS,
                              f"fp32 k=1 on PageRank's leftover rows ({nrest} rows of Pᵀ, {rest.nnz} entries, "
                              f"the longest {int(np.diff(np.asarray(rest.host().indptr)).max())})",
                              PRIOR_MS["ordered sum Pᵀ"])
    spmv_ms = cuda_ms(torch, lambda: ops.ell_spmv(E_pt, x_pt))
    say(f"phase 3 ell_spmv over Pᵀ (one PageRank product, K2 + the ordered sum) {spmv_ms:.4f} ms "
        f"(with index_add_: 2.5418, PERF.md)")
    del E_pt, contrib, P
    # ... and on blocked_spmm_slab's leftover stream at k = 128 (phase 6's
    # view of the same graph): 90,780 short segments, rows already sorted
    from spmm_tpu_torch.config import Config
    from spmm_tpu_torch.ops.blocked import _view_plan
    from spmm_tpu_torch.preprocess import preprocess

    P6 = preprocess(A_web, Config()).to(dev)
    view6 = ops.blocked_slab_view(P6)
    rem_cols, rem_vals, rem_seg = view6[1]
    B6 = torch.from_numpy(rng.standard_normal((WEB_N, 128)).astype(np.float32)).to(dev)
    contrib6 = B6.index_select(0, rem_cols) * rem_vals.float()[:, None]
    nseg6 = view6[2].shape[0] - sum(int(c.shape[0]) for _, c in view6[0])
    plan6 = _view_plan(view6, rem_seg, nseg6, sorted_ids=True)
    r_seg["stream_k128"] = ordered_sum_shape(
        torch, segments, contrib6, plan6, rem_seg, bound, FP32_FLOPS,
        f"fp32 k=128 on blocked_spmm_slab's leftover stream ({nseg6} segments, {contrib6.shape[0]} rows)",
        PRIOR_MS["ordered sum k=128 stream"])
    results["segment_sum"] = r_seg
    del P6, view6, B6, contrib6, plan6
    # K4 and K5, the slab SpGEMM's numeric phase, over the web-Google A×A
    results.update(slab_kernel_rows(torch, A_web, dev, rng, bound, FP32_FLOPS))

    # ---- 4. main path ------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        name = "webgoogle_like"
        mdir = os.path.join(tmp, "mat", "mtx", name)
        os.makedirs(mdir)
        t0 = time.perf_counter()
        write_mtx(os.path.join(mdir, f"{name}.mtx"), to_coo(A_web), pattern=True)
        with open(os.path.join(tmp, "matrix.txt"), "w") as f:
            f.write(f"{name}.mtx\n")
        say(f"phase 4 setup: wrote {name}.mtx ({(time.perf_counter() - t0) * 1e3:.1f} ms host)")

        B_csr = torch.from_numpy(rng.standard_normal((WEB_N, 128)).astype(np.float32)).to(dev)
        reset_counters()
        paths = {kname: [] for kname in counters()}
        t0 = time.perf_counter()
        rows: list = []
        # the CLI multiplies twice (first call, timed call): one K2 launch
        # each; its A×A is one cold ops.spgemm
        rc = launched(paths, "cli.main --spgemm --spmm 128 (ops.spgemm, ops.ell_spmm)", lambda: cli.main(
            ["--dir", tmp, "--spgemm", "--spmm", "128", "--check", "--device", "cuda"], results=rows),
            {"ell_slab_spmm": 2, "bsr_spmm": 0})
        y_csr = launched(paths, "ops.spmm(CSR)", lambda: ops.spmm(A_web, B_csr),
                         {"ell_slab_spmm": 1, "bsr_spmm": 0})
        y_bsr = launched(paths, "ops.spmm(BSR)", lambda: ops.spmm(Ab, B_band),
                         {"ell_slab_spmm": 0, "bsr_spmm": 1})
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
        launches = counters()

        require(rc == 0, f"cli.main returned {rc}")
        with open(os.path.join(tmp, "result.txt")) as f:
            result_txt = f.read()
    r = rows[0]
    say(f"phase 4 main: read {r['read_ms']:.1f} ms | preprocess {r['preprocess_ms']:.1f} ms | "
        f"spmm k=128 {r['spmm_ms']:.3f} ms (first {r['spmm_first_ms']:.3f}) | "
        f"spgemm {r['spgemm_ms']:.1f} ms | total {t_main * 1e3:.1f} ms | launches {launches}")
    say(f"phase 4 check: result.txt {result_txt.strip()!r} | spgemm out nnz {r['spgemm_out_nnz']} "
        f"(scipy {r['spgemm_ref_nnz']}, exact {r['spgemm_exact']}, max_err {r['spgemm_max_err']}) | "
        f"spmm max_err {r['spmm_max_err']:.3e}")
    require(re.fullmatch(rf"{name} \d+\.\d+ms\n", result_txt) is not None,
            f"result.txt is not '<name> <ms>ms': {result_txt!r}")
    require(r["spgemm_exact"], "A×A indptr/indices differ from scipy's")
    require(r["spgemm_max_err"] == 0.0, "A×A pattern counts differ from scipy's")
    require(r["check_ok"], "the CLI's --check failed")
    ref_csr = A_web.to_scipy() @ B_csr.cpu().numpy()
    err_csr = float(np.abs(y_csr.cpu().numpy() - ref_csr).max())
    require(err_csr <= 1e-4 * max(1.0, float(np.abs(ref_csr).max())),
            f"ops.spmm(CSR) differs from scipy: {err_csr:.3e}")
    _, rel_bsr = max_errs(y_bsr, bsr_kernel.bsr_spmm_reference(Ab, B_band))
    require(rel_bsr <= RTOL_F32, f"ops.spmm(BSR) differs from its plain version: {rel_bsr:.3e}")
    # the CLI's A×A is one cold ops.spgemm: K4 (b), one launch per
    # block-size group of its chunks, then K5
    for kname in ("ell_slab_spmm", "bsr_spmm", "slab_fetch_merge", "slab_compact"):
        require(launches[kname] > 0, f"kernel {kname} was not launched on the main path")
    require(launches["slab_fetch_merge"] <= len(slab_kernel.MERGE_GROUPS) and launches["slab_compact"] == 1,
            f"the CLI's A×A took {launches['slab_fetch_merge']} K4 (b) launches (at most one per block-size "
            f"group, {len(slab_kernel.MERGE_GROUPS)}) and {launches['slab_compact']} K5 (one)")

    ref_C, spgemm_times = slab_phase(torch, A_web, dev, rng, cli_spgemm_ms=r["spgemm_ms"])

    # ---- 6. the BlockedCSR path and the rest of slice 3 --------------------
    reset_counters()
    launches6, P, view = blocked_phase(torch, A_web, E, Ab, A_band, ref_C, dev, rng, paths,
                                       k2_ell_ms=results["ell_slab_spmm"]["ms"])
    require(launches6["ell_slab_spmm"] > 0, "K2 was not launched on the blocked path (phase 6)")
    for kname, n in launches6.items():
        launches[kname] += n

    # ---- 7. gradients, fp64 and the examples -------------------------------
    reset_counters()
    launches7 = grad_phase(torch, A_web, E, Ab, A_band, P, view, dev, rng, paths, root)
    for kname, n in launches7.items():
        require(n > 0 or kname in SPGEMM_KERNELS, f"kernel {kname} was not launched on this slice's path (phase 7)")
        launches[kname] += n

    # ---- 8. the distribution layer -----------------------------------------
    reset_counters()
    launches8 = dist_phase(torch, A_web, ref_C, dev, rng, paths, root)
    require(launches8["ell_slab_spmm"] >= 4, "K2 was not launched on every distributed SpMM (phase 8)")
    for kname in SPGEMM_KERNELS:  # spmd / csr / big: K4 (b) and K5; plan: (a); exec: (c)
        require(launches8[kname] > 0, f"kernel {kname} was not launched on the distributed SpGEMMs (phase 8a)")
    for kname, n in launches8.items():
        launches[kname] += n

    # ---- 9. measured primitive rates and the attainable shares -------------
    shares = rates_phase(torch, A_web, E, dev, rng, results["ell_slab_spmm"], spgemm_times)
    k2_line = results["ell_slab_spmm"]  # K2's attainable share (this run's probe) beside its roofline share
    k2_line.update(share=k2_line["bound_ms"] / k2_line["ms"], attainable_ms=shares["K2 k=128"]["attainable_ms"],
                   attainable_share=shares["K2 k=128"]["attainable_share"])

    # ---- 10. the port's benchmark, quick ----------------------------------
    bench_phase(torch, root)

    # ---- 11. report --------------------------------------------------------
    k2, k1 = "spmm_tpu/ops/pallas_ell.py:82", "spmm_tpu/ops/pallas_bsr.py:38"
    replaces = {
        "bsr_spmm": ("spmm_tpu_torch/csrc/bsr_spmm.cu", k1),
        "ell_slab_spmm": ("spmm_tpu_torch/csrc/ell_slab_spmm.cu", k2),
        "ell_slab_sddmm": ("spmm_tpu_torch/csrc/ell_slab_sddmm.cu",
                           f"{k2} (no TPU counterpart: backward of K2, values)"),
        "ell_slab_spmm_transposed": ("spmm_tpu_torch/csrc/ell_slab_spmm.cu",
                                     f"{k2} (no TPU counterpart: backward of K2, B; K2 on the transposed pack)"),
        "bsr_spmm_transposed": ("spmm_tpu_torch/csrc/bsr_spmm.cu",
                                f"{k1} (no TPU counterpart: backward of K1, B; bsr_t_kernel, A's blocks read "
                                "in place)"),
        "segment_sum": ("spmm_tpu_torch/csrc/segment_sum.cu",
                        "spmm_tpu/ops/spmm.py:41 (no TPU kernel: the XLA segment_sum of the gather paths, "
                        "jax.ops.segment_sum; the ordered sum in place of atomic index_add_)"),
        "slab_fetch": ("spmm_tpu_torch/csrc/slab_spgemm.cu",
                       "spmm_tpu/ops/slab_spgemm.py:1012 (no TPU kernel: the XLA chunk fetch _chunk_fetch; "
                       "K4 (a), the class-aligned cache)"),
        "slab_fetch_merge": ("spmm_tpu_torch/csrc/slab_spgemm.cu",
                             "spmm_tpu/ops/slab_spgemm.py:1012 + :1073 (no TPU kernel: the XLA _chunk_fetch and "
                             "_merge_block, fused; K4 (b))"),
        "slab_merge": ("spmm_tpu_torch/csrc/slab_spgemm.cu",
                       "spmm_tpu/ops/slab_spgemm.py:1073 (no TPU kernel: the XLA sort-merge _merge_block of a "
                       "cached slab; K4 (c))"),
        "slab_compact": ("spmm_tpu_torch/csrc/slab_spgemm.cu",
                         "spmm_tpu/ops/slab_spgemm.py:1280 (no TPU kernel: the XLA _compact_to_csr; K5)"),
    }
    report = [
        {"name": kname, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[kname], "paths": paths[kname], **results[kname]}
        for kname, (src, rep) in replaces.items()
    ]
    say(json.dumps({"kernels": report}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
