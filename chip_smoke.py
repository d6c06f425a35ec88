#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``spmm_tpu_torch``) once on one NVIDIA GPU.

Phases, each printing one line with its times (CUDA events for kernels,
``torch.cuda.synchronize()`` around ``perf_counter`` for host phases):

1. device   — require CUDA; print ``nvidia-smi`` name and power limit.
2. build    — build the CUDA kernels (nvcc) and the native host library (g++)
              from this checkout's sources; print the nvcc version.
3. kernels  — each hand-written kernel against its plain PyTorch version on
              the card: K1 (BSR) through ``ops.spmm(BSR, B)`` on
              ``banded_random(65536, 512, 0.25, seed=3)`` at k=128 in fp32 and
              bf16; K2 over all 78 slabs of the ELL pack of
              ``webgraph_like(916_428, 5_105_039, seed=0)`` (web-Google size)
              in one launch at k=128 and k=32.  Per kernel and shape: max
              error, kernel / plain / library ms (CUDA events, mean of 10),
              the bound computed from these matrices (bytes at 3.35 TB/s or
              operations at the type's peak, whichever is larger; for K1
              fp32 also the fp32-FMA and the 3xTF32 tensor-core bounds), the
              share of it reached, and the time before the kernel's redesign
              (from PERF.md, printed only).
4. main     — the port's main path with every launch counter at 0: the CLI
              (.mtx ingest → preprocess → ELL SpMM k=128 → exact A×A through
              the slab SpGEMM, --check against scipy) on the web-Google-sized
              graph, then the SpMM dispatcher on the BSR and CSR forms.
              Requires exact C structure, SpMM within tolerance, and every
              kernel launched.
5. slab     — the slab SpGEMM's entry points on the same graph, each product
              held against one scipy A×A: the plan (with its aligned cache),
              its numeric phase and the chain of 8 (CUDA events), the device
              CSR, ``ops.spgemm`` three times (cold, plan build, plan reuse),
              a value-mode product, the global-sort ``spgemm_sorted``, the
              4-piece big path with a checkpoint and its resume (0 pieces
              recomputed), peak device memory, and a profiler breakdown of the
              warm numeric phase by op.
6. blocked  — slice 3 on the same graph, with the launch counters at 0 again:
              ``preprocess`` → the slab views → ``blocked_spmm_slab`` at k=128
              (one K2 launch over all v8-group buckets; against its plain
              version and scipy), the other BlockedCSR formulations, the 3-step
              ``blocked_chain_spmv``, SpGEMM → SpMM on the device CSR (packed
              by ``ell_pack_device``, one K2 launch), ``bitmap_perm_device``
              (equal to the host permutation), ``bsr_spmv``, ``sddmm`` and
              ``entry()``; then each timed (CUDA events) beside ``ell_spmm``.
7. report   — one JSON line of per-kernel results (launches of phases 4 and 6,
              the entry points that launched each kernel, phase 3's times,
              bound and library time at the main-path shape), the card's name
              and power limit, and the final ``{"ok": true, ...}`` line.

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
#: the H100 SXM's published rates (NVIDIA's H100 datasheet): HBM bytes/s,
#: fp32 FLOP/s outside the tensor cores, dense tf32 and bf16 tensor-core FLOP/s
HBM_BPS, FP32_FLOPS, TF32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 495e12, 989e12
#: each kernel's time at the phase 3 shapes before its redesign for Hopper,
#: printed beside the new one (PERF.md's kernel table; not a measurement of
#: this run, so not in the kernels line)
PRIOR_MS = {"K2 k=128": 2.8529, "K2 k=32": 2.6395, "K1 fp32": 0.8087}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(line: str) -> None:
    print(line, flush=True)


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (warm L2)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def traced(paths: dict, name: str, fn):
    """Run ``fn`` and add ``name`` to the paths of every kernel it launched."""
    from spmm_tpu_torch.ops import bsr_kernel, ell_kernel

    mods = {"ell_slab_spmm": ell_kernel, "bsr_spmm": bsr_kernel}
    before = {k: m.launches for k, m in mods.items()}
    out = fn()
    for k, m in mods.items():
        if m.launches > before[k] and name not in paths[k]:
            paths[k].append(name)
    return out


def launched(paths: dict, name: str, fn, want: dict):
    """``traced``, and fails unless ``fn`` launched each kernel in ``want``
    exactly that many times (one K2 launch per product)."""
    from spmm_tpu_torch.ops import bsr_kernel, ell_kernel

    mods = {"ell_slab_spmm": ell_kernel, "bsr_spmm": bsr_kernel}
    before = {k: m.launches for k, m in mods.items()}
    out = traced(paths, name, fn)
    for k, n in want.items():
        got = mods[k].launches - before[k]
        require(got == n, f"{name}: {got} {k} launches, expected {n}")
    return out


def device_breakdown(prof, n: int):
    """A profile's device time per run of ``n``: (ops by the device time of
    the kernels each launched, kernels and copies by their time, busy ms)."""
    from torch.autograd import DeviceType

    events = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
    by_op = [e for e in events if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    by_kernel = [e for e in events if e.device_type != DeviceType.CPU]
    return by_op, by_kernel, sum(e.self_device_time_total for e in by_kernel) / n / 1e3


def slab_phase(torch, A, dev, rng, cli_spgemm_ms: float):
    """Phase 5: the slab SpGEMM's entry points at full size, each product held
    against one scipy A×A, which it returns (phase 6 reuses it)."""
    from torch.profiler import ProfilerActivity, profile

    from spmm_tpu_torch import ops
    from spmm_tpu_torch.ops import slab_spgemm as ss

    timed = functools.partial(host_timed, torch)

    def peak_since(base):
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    def reset():
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    t_phase = t0 = time.perf_counter()
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
    plan, t_plan = timed(lambda: ss.spgemm_plan(A, A, device=dev, sizing=sizing))
    plan_gb = (torch.cuda.memory_allocated() - base) / 1e9
    (outs, _, _), t_num_first = timed(lambda: ss.spgemm_slab_device(A, A, plan))
    num_ms = cuda_ms(torch, lambda: ss.spgemm_slab_device(A, A, plan), iters=5)
    chain_ms = cuda_ms(torch, lambda: ss.spgemm_chain_device(plan, 8), iters=1, warmup=1) / 8
    nnz_pad = ss._round_up(exp_pad, 1024)
    Cd, t_compact = timed(lambda: ss._csr_of(outs, (A.nrow, A.ncol), nnz_pad, torch.float32, dev))
    Ch, t_d2h = timed(lambda: ss._csr_to_host(Cd))
    held_against(Ch, ref, "plan numeric")
    peak_plan = peak_since(base)
    held_against(ss._csr_of(ss.spgemm_chain_device(plan, 2), (A.nrow, A.ncol), nnz_pad,
                            torch.float32, dev), ref, "spgemm_chain_device")
    say(f"phase 5 plan: build {t_plan:.1f} ms (first {t_plan_first:.1f}), tables + aligned cache "
        f"{plan_gb:.3f} GB | numeric {num_ms:.3f} ms (CUDA events, first {t_num_first:.1f} ms host) | "
        f"chain {chain_ms:.3f} ms/product (8, one sync) | compaction {t_compact:.1f} ms | "
        f"D2H {t_d2h:.1f} ms | peak {peak_plan:.3f} GB | numeric and chain exact")

    # the device stages apart (ROADMAP queue 2): S2 expansion (the chunks'
    # gathers, which the aligned cache runs once), S1 sort+merge (the aligned
    # numeric phase), S3 compaction
    def fetch_all():
        for L, R_pad, start, cnt in sched:
            base_, bm = ss._chunk_meta(plan.rowmeta, start, cnt, R_pad, L // W)
            ss._chunk_fetch(plan, base_, bm, L=L, R_pad=R_pad, W=W, accum_dtype=torch.float32,
                            pattern=plan.pattern)

    s2_ms = cuda_ms(torch, fetch_all, iters=3, warmup=1)
    s3_ms = cuda_ms(torch, lambda: ss._compact_to_csr(outs, nrow=A.nrow, nnz_pad=nnz_pad,
                                                       dtype=torch.float32, device=dev), iters=3, warmup=1)
    say(f"phase 5 stages (CUDA events): S2 expansion {s2_ms:.3f} ms | S1 sort+merge {num_ms:.3f} ms | "
        f"S3 compaction {s3_ms:.3f} ms")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ss.spgemm_slab_device(A, A, plan)
        torch.cuda.synchronize()
    by_op, by_kernel, busy = device_breakdown(prof, 3)
    say(f"phase 5 profile, warm numeric (device ms per product, busy {busy:.3f}): by op: "
        + " | ".join(f"{e.key} x{e.count // 3} {e.self_device_time_total / 3e3:.3f}" for e in by_op[:6])
        + " || by kernel: "
        + " | ".join(f"{e.key[:70]} x{e.count // 3} {e.self_device_time_total / 3e3:.3f}"
                     for e in by_kernel[:6]))
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, t = timed(lambda: ops.spgemm(A, A, device=dev))
        _, by_kernel, busy = device_breakdown(prof, 1)
        copies = sum(e.self_device_time_total for e in by_kernel if e.key.startswith("Memcpy")) / 1e3
        idle.append(f"{label}: {t:.1f} ms under the profiler, device busy {busy:.3f} ms "
                    f"(copies {copies:.3f}), idle {100 * (1 - busy / t):.1f}%")
        ss._PLAN_SEEN.clear()
        ss._PLAN_CACHE.clear()
    say("phase 5 idle share of ops.spgemm: " + " | ".join(idle))

    Av = dataclasses.replace(A, data=rng.standard_normal(np.asarray(A.data).shape).astype(np.float32))
    ref_v = scipy_square(Av.to_scipy())
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
    say(f"phase 5 big path: 4 pieces {t_big:.1f} ms, peak {peak_big:.3f} GB, exact | resume "
        f"{t_resume:.1f} ms, 0 pieces recomputed, exact | phase 5 took {time.perf_counter() - t_phase:.1f} s")
    return ref


def blocked_phase(torch, A, E, Ab, A_band, ref_C, dev, rng, paths, k2_ell_ms: float) -> dict:
    """Phase 6: the BlockedCSR SpMM (the driver's single-chip forward) and
    the rest of slice 3 at web-Google size.  Every entry point runs once
    (the path, with the launch counts set to 0 by the caller), then each
    result is held against scipy or its plain version and timed.  Returns
    each kernel's launch count at the end of the path run."""
    from torch.profiler import ProfilerActivity, profile

    from spmm_tpu_torch import ops
    from spmm_tpu_torch.config import Config
    from spmm_tpu_torch.entry import entry
    from spmm_tpu_torch.formats import ell_pack_device
    from spmm_tpu_torch.ops import blocked as bl
    from spmm_tpu_torch.ops import bsr_kernel, ell_kernel
    from spmm_tpu_torch.preprocess import bitmap_perm_device, bitmap_reorder, preprocess

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
    path_launches = {"ell_slab_spmm": ell_kernel.launches, "bsr_spmm": bsr_kernel.launches}

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.blocked_spmm_slab(P, B, view)
        torch.cuda.synchronize()
    _, by_kernel, busy = device_breakdown(prof, 3)
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
    say(f"phase 6 profile, blocked_spmm_slab k=128 (device ms per call, busy {busy:.3f}): by kernel: "
        + " | ".join(f"{e.key[:60]} x{e.count // 3} {e.self_device_time_total / 3e3:.3f}"
                     for e in by_kernel[:6]))
    return path_launches


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
    from spmm_tpu_torch.ops import bsr_kernel, ell_kernel
    from spmm_tpu_torch.ops.ell_spmm import slab_row_keys

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
    def bound(nbytes: float, ops_: float, peak: float):
        """The least time (ms) for the work: bytes at the HBM rate or
        operations at the type's peak, whichever is larger, and which."""
        t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops_ / peak * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def csr_tensor(A):
        """A host CSR as a CUDA ``torch.sparse_csr_tensor``: the library
        yardstick's operand, never used by the port."""
        t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
        return torch.sparse_csr_tensor(t(A.indptr, np.int64), t(A.indices[: A.nnz], np.int64),
                                       t(A.data[: A.nnz], np.float32), size=A.shape)

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
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS if name == "fp32" else BF16_FLOPS)
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
    del S_web

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
        ell_kernel.launches = 0
        bsr_kernel.launches = 0
        paths = {"ell_slab_spmm": [], "bsr_spmm": []}
        t0 = time.perf_counter()
        rows: list = []
        # the CLI multiplies twice (first call, timed call): one K2 launch each
        rc = launched(paths, "cli.main --spmm 128 (ops.ell_spmm)", lambda: cli.main(
            ["--dir", tmp, "--spgemm", "--spmm", "128", "--check", "--device", "cuda"], results=rows),
            {"ell_slab_spmm": 2, "bsr_spmm": 0})
        y_csr = launched(paths, "ops.spmm(CSR)", lambda: ops.spmm(A_web, B_csr),
                         {"ell_slab_spmm": 1, "bsr_spmm": 0})
        y_bsr = launched(paths, "ops.spmm(BSR)", lambda: ops.spmm(Ab, B_band),
                         {"ell_slab_spmm": 0, "bsr_spmm": 1})
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
        launches = {"ell_slab_spmm": ell_kernel.launches, "bsr_spmm": bsr_kernel.launches}

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
    for kname, n in launches.items():
        require(n > 0, f"kernel {kname} was not launched on the main path")

    ref_C = slab_phase(torch, A_web, dev, rng, cli_spgemm_ms=r["spgemm_ms"])

    # ---- 6. the BlockedCSR path and the rest of slice 3 --------------------
    ell_kernel.launches = 0
    bsr_kernel.launches = 0
    launches6 = blocked_phase(torch, A_web, E, Ab, A_band, ref_C, dev, rng, paths,
                              k2_ell_ms=results["ell_slab_spmm"]["ms"])
    require(launches6["ell_slab_spmm"] > 0, "K2 was not launched on the blocked path (phase 6)")
    for kname, n in launches6.items():
        launches[kname] += n

    # ---- 7. report ---------------------------------------------------------
    replaces = {
        "bsr_spmm": ("spmm_tpu_torch/csrc/bsr_spmm.cu", "spmm_tpu/ops/pallas_bsr.py:38"),
        "ell_slab_spmm": ("spmm_tpu_torch/csrc/ell_slab_spmm.cu", "spmm_tpu/ops/pallas_ell.py:82"),
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
