#!/usr/bin/env python
"""Benchmark harness of the PyTorch/CUDA port (``spmm_tpu_torch``), the port
of ``bench.py``: prints ONE JSON line,
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}
under ``bench.py``'s keys where both measure the same thing.

Headline: end-to-end preprocessing time (host) on a web-Google-sized
synthetic graph (916,428², ~5.1M nnz), min of 9.  vs_baseline = 494.6 ms /
value: 494.6 ms is the reference's serial binary rebuilt from source and run
on the same synthetic on another machine's CPU (BASELINE.md, 2026-08-17),
not on this machine's host.

Extras, on the card (CUDA events for kernels, host clock around work that
ends in a copy to the host for the SpGEMM): SpGEMM A×A cold, plan build,
warm (plan reuse) and a chain of 8 products; SpMM through K2 (``ell_spmm``
at k=128 and 32, ``ell_spmv``), K1 (``bsr_spmm``), the BlockedCSR path;
the synthetic suite; ``spgemm_dist_big`` on NCCL at world size 1; and, last,
the scaling curve (``python -m spmm_tpu_torch.utils.scaling`` on the same
device: NCCL ranks, one card each, so one rank on a one-card machine; gloo
ranks on the host's CPUs with ``--device cpu``).  Each product beside its
datasheet roofline share (``*_sol_frac``) and its share of the
measured-primitive bound (``*_att_frac``, ``ops.roofline``, from
``spmm_tpu_torch/primitive_rates_h100.json``); both only on an H100 SXM:
on another card, and with ``--device cpu``, the line has the times and no
share.

Where it differs from ``bench.py``: a timed SpMM step multiplies the same B
each time (no ``y / max|y|`` fed back: that stopped XLA from hoisting a
loop-invariant product, and in PyTorch it would add a reduction and a divide
over the whole (m, k) output, ~1.4 GB of traffic at k=128 on web-Google);
the kernels are built before the headline by one tiny ``ell_spmm`` (no
compile cache); the power limit is in the line (``power_limit``); there is
no ``--measure-reference`` (the reference binary is not in the repository);
the signal handlers and the watchdog are set up in ``main()``, not at
import; and the exit code is nonzero when the line holds an ``*_error``,
``error`` or ``interrupted`` key (a section the deadline skipped is listed
in ``skipped`` and is no error).

Budget: every section is gated on a deadline (``BENCH_BUDGET_S``, default
720 s), headline first, and writes into the result as soon as a number
exists; SIGTERM, SIGALRM (45 s past the budget) and a watchdog thread (at
the budget) print whatever was measured.

Usage: python bench_torch.py [--quick] [--full] [--no-kernels] [--no-spgemm]
                             [--no-suite] [--no-scaling] [--matrix PATH]
                             [--device cuda|cpu]
On the card with no arguments; ``--device cpu`` runs the kernels' plain
versions on the CPU (for tests: its times are no device metric).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
#: the reference's serial binary rebuilt from source, min of 5 on the same
#: calibrated synthetic, re-measured 2026-08-17 on another machine's CPU
#: (BASELINE.md); not a measurement of this machine
REFERENCE_PREPROCESS_MS = 494.6
WEBGOOGLE_N = 916_428
WEBGOOGLE_NNZ = 5_105_039
QUICK_N, QUICK_NNZ = 50_000, 300_000
#: BASELINE config 4: banded_random(n, band, density, seed=3) in (8, 128) blocks
BSR_SHAPE = (65536, 512, 0.25)
#: products in one chain (one synchronisation)
NCHAIN = 8
#: the reference's evaluation suite (its README) as synthetic stand-ins of
#: the same shape and nnz
SUITE = {
    "web-Stanford": (281_903, 2_312_497),
    "web-Google": (916_428, 5_105_039),
    "sx-askubuntu": (159_316, 964_437),
}
#: spgemm_dist_big's graph: webgraph_like(n, nnz, seed=5), in 4 pieces
DIST_BIG = (1_000_000, 8_000_000, 4)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Bench:
    """One run's result line, its deadline and the processes it started.
    Every section writes into ``result`` the moment a number exists, so a
    line printed by a signal handler or the watchdog holds what was
    measured."""

    def __init__(self, budget_s: float):
        self.t0 = time.monotonic()
        self.budget_s = budget_s
        self.result: dict = {"metric": "preprocess_ms_webgoogle_synthetic", "value": None,
                             "unit": "ms", "vs_baseline": None}
        self.children: list = []
        self._emitted = False
        self._lock = threading.Lock()

    def time_left(self) -> float:
        return self.budget_s - (time.monotonic() - self.t0)

    def gate(self, section: str, need_s: float) -> bool:
        """True if there is budget to start ``section`` (estimated cost
        ``need_s``); else lists it in ``skipped``."""
        if self.time_left() >= need_s:
            return True
        log(f"SKIP {section}: {self.time_left():.0f}s left < {need_s:.0f}s needed")
        self.result.setdefault("skipped", []).append(section)
        return False

    def failed(self) -> bool:
        return any(k == "error" or k.endswith("_error") or k == "interrupted" for k in self.result)

    def emit(self) -> None:
        """Print the line once, whatever state the run reached.  The lock is
        taken with a timeout: a signal handler runs on the main thread and
        may interrupt an emit that holds it (a duplicate line beats none);
        ``_emitted`` flips only after the print."""
        acquired = self._lock.acquire(timeout=10.0)
        try:
            if self._emitted:
                return
            self.result["bench_wall_s"] = round(time.monotonic() - self.t0, 1)
            line = json.dumps({k: self.result.get(k) for k in ("metric", "value", "unit", "vs_baseline")})
            for _ in range(3):  # the main thread may be writing into the dict
                try:
                    line = json.dumps(dict(self.result), default=str)
                    break
                except (RuntimeError, TypeError, ValueError):
                    continue
            print(line, flush=True)
            self._emitted = True
        finally:
            if acquired:
                self._lock.release()

    def stop(self, why: str, code: int) -> None:
        """Record ``interrupted``, print the line, end the started processes
        and exit at once with ``code``."""
        self.result["interrupted"] = why
        self.emit()
        for p in self.children:
            kill_group(p)
        os._exit(code)

    def install_handlers(self) -> None:
        """SIGTERM / SIGALRM print the line and exit nonzero; the alarm fires
        45 s past the budget.  A daemon thread does the same at the budget:
        a signal handler runs only between bytecodes, so a main thread
        blocked inside a long native call would defer it."""
        def on_signal(signum, frame):
            self.stop(signal.Signals(signum).name, 128 + signum)

        signal.signal(signal.SIGTERM, on_signal)
        signal.signal(signal.SIGALRM, on_signal)
        signal.alarm(int(self.budget_s) + 45)

        def watchdog():
            while True:
                left = self.time_left()
                if left <= 0:
                    self.stop("WATCHDOG_BUDGET", 124)
                time.sleep(min(left, 5.0))

        threading.Thread(target=watchdog, daemon=True, name="bench-watchdog").start()


def kill_group(proc) -> None:
    """SIGKILL to a started process and every process of its session."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _card(dev) -> dict:
    """The card's name and ``nvidia-smi``'s name and power limit of that
    card; for the CPU, the word ``cpu``."""
    import torch

    from spmm_tpu_torch.utils.primitives import power_limit

    if dev.type != "cuda":
        return {"device": "cpu"}
    return {"device": torch.cuda.get_device_name(dev), "power_limit": power_limit(dev)}


def chip_of(dev):
    """The datasheet entry for the shares: ``ops.roofline.detect_chip`` on
    the card, None on the CPU or a card without an entry (the line then
    holds the times and no share)."""
    from spmm_tpu_torch.ops.roofline import detect_chip

    if dev.type != "cuda":
        return None
    try:
        return detect_chip(dev)
    except ValueError as e:
        log(f"no shares: {e}")
        return None


def build_kernels(dev) -> float:
    """One tiny ``ell_spmm`` on the card: the lazy nvcc build of every
    kernel, so that no section pays for it.  Returns its ms."""
    import torch

    from spmm_tpu_torch import ops
    from spmm_tpu_torch.formats import ell_pack, webgraph_like

    t0 = time.perf_counter()
    if dev.type == "cuda":
        E = ell_pack(webgraph_like(256, 1024, seed=0)).to(dev)
        ops.ell_spmm(E, torch.ones((256, 8), device=dev))
        _sync(dev)
    return (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------- sections
def bench_preprocess(A, cfg, iters=9):
    """Min of ``iters`` host preprocess runs (the host is noisy) and the
    packed result."""
    from spmm_tpu_torch.preprocess import preprocess

    times, P = [], None
    for _ in range(iters):
        t0 = time.perf_counter()
        P = preprocess(A, cfg)
        times.append((time.perf_counter() - t0) * 1e3)
    log("preprocess ms per run: " + ", ".join(f"{t:.1f}" for t in times))
    return min(times), P


def record_headline(b: Bench, A, pre_ms: float, P, baseline_ms: float) -> None:
    b.result["value"] = round(pre_ms, 2)
    b.result["vs_baseline"] = round(baseline_ms / pre_ms, 4) if baseline_ms == baseline_ms else None
    b.result.update(
        nnz=int(A.nnz),
        n=int(A.shape[0]),
        preprocess_mnnz_per_s=round(A.nnz / (pre_ms * 1e-3) / 1e6, 2),
        regions=int(P.nregions),
        v8_groups=int(P.ngroups),
    )


def _cold_spgemm(A, Ad, pattern: bool, W: int, classes):
    """One cold slab SpGEMM as ``bench.py`` times it: the host sizing of A,
    then the plan tables, the chunks' gathers and their sort-merge on the
    device operands, fenced by copying the last chunk's ``nuniq[:1]`` to the
    host (no compaction, no CSR copy)."""
    from spmm_tpu_torch.ops import slab_spgemm as ss

    sizing = ss._sizing(A, A, W, classes)
    outs, tails, _ = ss.spgemm_slab_device(Ad, Ad, sizing=sizing, pattern=pattern)
    if outs:
        outs[-1][3][:1].cpu()
    return outs, tails, sizing


def _chunk_nnz(outs) -> int:
    return int(sum(int(o[3].sum()) for o in outs))


def bench_spgemm(b: Bench, A, device, chip=None) -> None:
    """The slab SpGEMM A×A on the device operands: cold (min of 5 after a
    first call), plan build (min of 2), warm with the plan's aligned cache
    (min of 5), a chain of ``NCHAIN`` products with one synchronisation (min
    of 3, per product); host clock around each, fenced by a copy of a few
    bytes to the host.  The timings cover the slab chunks, as ``bench.py``'s;
    ``spgemm_out_nnz`` also counts the heavy-tail rows' nonzeros (their
    global-sort product, untimed).  Then the projected 8-shard balance."""
    import torch

    from spmm_tpu_torch.ops import spgemm_expand_bound
    from spmm_tpu_torch.ops import slab_spgemm as ss
    from spmm_tpu_torch.ops.roofline import spgemm_attainable, spgemm_roofline, spgemm_warm_attainable
    from spmm_tpu_torch.parallel.partition import partition_rows
    from spmm_tpu_torch.parallel.spgemm_spmd import _per_shard_sizing

    out = b.result
    dev = torch.device(device)
    W = ss.DEFAULT_SEG_W
    cl = ss._norm_classes(ss.DEFAULT_CLASSES, W)
    expand = spgemm_expand_bound(A, A)
    log(f"spgemm expansion: {expand / 1e6:.1f} M partial products")
    pattern = ss._is_pattern(A)
    Ad = A.to(dev)  # resident on the device, as in steady-state use

    outs, tails, sizing = _cold_spgemm(A, Ad, pattern, W, cl)  # first call
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        outs, tails, sizing = _cold_spgemm(A, Ad, pattern, W, cl)
        times.append((time.perf_counter() - t0) * 1e3)
    ms = min(times)
    body_nnz = _chunk_nnz(outs)
    out_nnz = body_nnz
    if len(tails):
        tr, _, _ = ss._tail_products(A.host(), np.asarray(tails, np.int64), A.host(), torch.float32, dev)
        out_nnz += len(tr)
    log(f"spgemm_slab: {ms:.1f} ms, out_nnz={out_nnz} ({len(tails)} tail rows)")
    out["spgemm_ms"] = round(ms, 2)
    out["spgemm_gflops"] = round(2.0 * expand / (ms * 1e-3) / 1e9, 3)
    out["spgemm_mnnz_out_per_s"] = round(out_nnz / (ms * 1e-3) / 1e6, 2)
    out["spgemm_out_nnz"] = out_nnz

    att_kw = ss.attainable_kwargs(sizing, A.shape[0], out_nnz, cl, W=W)
    chunk_slots = att_kw["chunk_slots"]
    slots = sizing.npa * W
    if chip is not None:
        out["spgemm_sol_frac"] = round(
            spgemm_roofline(expand, A.nnz, A.nnz, out_nnz, chip=chip).efficiency(ms * 1e-3), 4)
        out["spgemm_att_frac"] = round(
            spgemm_attainable(sizing.npa, slots, A.nnz, **att_kw) / (ms * 1e-3), 4)
    del outs

    # plan once, multiply many: the plan build, then its numeric phase alone
    if b.gate("spgemm_warm_run", 200):
        try:
            pts = []
            plan = None
            for _ in range(2):
                del plan
                t0 = time.perf_counter()
                plan = ss.spgemm_plan(Ad, Ad, sizing=ss._sizing(A, A, W, cl), pattern=pattern)
                plan.rows_sorted[:1].cpu()
                pts.append((time.perf_counter() - t0) * 1e3)
            out["spgemm_plan_ms"] = round(min(pts), 2)

            def run_warm():
                outs_w, _, _ = ss.spgemm_slab_device(Ad, Ad, plan)
                outs_w[-1][3][:1].cpu()
                return outs_w

            wnnz = _chunk_nnz(run_warm())
            if wnnz != body_nnz:
                raise RuntimeError(f"the warm product has {wnnz} nonzeros in its chunks, the cold {body_nnz}")
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                run_warm()
                times.append((time.perf_counter() - t0) * 1e3)
            wms = min(times)
            log(f"spgemm_warm (plan reuse): {wms:.2f} ms")
            out["spgemm_warm_ms"] = round(wms, 2)
            out["spgemm_warm_mnnz_out_per_s"] = round(out_nnz / (wms * 1e-3) / 1e6, 2)
            if chip is not None:
                out["spgemm_warm_att_frac"] = round(
                    spgemm_warm_attainable(slots, out_nnz, chunk_slots=chunk_slots) / (wms * 1e-3), 4)

            ss.spgemm_chain_device(plan, 2)[-1][3][:1].cpu()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                outs_c = ss.spgemm_chain_device(plan, NCHAIN)
                outs_c[-1][3][:1].cpu()  # one fence for all of them
                times.append((time.perf_counter() - t0) * 1e3)
            cms = min(times) / NCHAIN
            if _chunk_nnz(outs_c) != body_nnz:
                raise RuntimeError("the chain's last product differs in its nonzeros from the cold one")
            log(f"spgemm_chain ({NCHAIN} products, one fence): {cms:.2f} ms/product")
            out["spgemm_chain_ms"] = round(cms, 2)
            if chip is not None:
                out["spgemm_chain_att_frac"] = round(spgemm_warm_attainable(
                    slots, out_nnz, dispatches=1.0 / NCHAIN, chunk_slots=chunk_slots) / (cms * 1e-3), 4)
            del plan, outs_c
        except Exception as e:  # keep the cold numbers
            log("spgemm warm bench failed:", traceback.format_exc())
            out["spgemm_warm_error"] = repr(e)[:200]

    # the projected 8-rank efficiency cap of the SPMD SpGEMM (no traffic
    # between shards): mean / max of the shards' padded expansions
    S8 = partition_rows(A, 8)
    _, counts8, _, _, _ = _per_shard_sizing(S8, A, W, cl)
    exp8 = (counts8[:, : len(cl)] * np.asarray(cl)[None, :]).sum(axis=1)
    out["spgemm_shard_balance_8"] = float(exp8.mean() / exp8.max())


def bench_kernels(b: Bench, A, P, device, chip=None, *, k: int = 128, full: bool = False,
                  bsr_shape=BSR_SHAPE) -> None:
    """SpMM / SpMV: per-step time of ``measure_device_loop`` (CUDA events
    around 8 back-to-back steps, median of 3 repeats), each step the product
    of the same operands.  K2 through ``ell_spmm`` / ``ell_spmv`` on A's ELL
    pack (k=128, 32, 1), K1 through ``bsr_spmm`` and ``bsr_spmv`` on
    ``banded_random(*bsr_shape, seed=3)``, the dispatcher on the raw CSR
    (its memoized pack), ``blocked_spmm_slab`` on the packed format; with
    ``full``, the dispatcher at k=128 and the gather + ordered-sum path."""
    import torch

    from spmm_tpu_torch import ops
    from spmm_tpu_torch.formats import banded_random, csr_to_bsr, ell_pack
    from spmm_tpu_torch.ops.roofline import spmm_attainable, spmm_roofline, spmv_attainable, spmv_roofline
    from spmm_tpu_torch.utils.timing import measure_device_loop, measure_host

    out = b.result
    dev = torch.device(device)
    m, n = A.shape
    B0 = torch.from_numpy(np.random.default_rng(0).standard_normal((n, k)).astype(np.float32)).to(dev)
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(n).astype(np.float32)).to(dev)

    def loop(name, fn, *operands):
        t = measure_device_loop(lambda c, *ops_: fn(*ops_), None, operands, name=name, iters=8)
        log(t)
        return t.median_ms

    def record(prefix, ms, flops, rl=None):
        out[f"{prefix}_ms"] = round(ms, 4)
        out[f"{prefix}_gflops"] = round(flops / (ms * 1e-3) / 1e9, 2)
        if rl is not None:
            out[f"{prefix}_sol_frac"] = round(rl.efficiency(ms * 1e-3), 4)

    rl = spmm_roofline(A.nnz, m, n, k, chip=chip) if chip is not None else None
    rlv = spmv_roofline(A.nnz, m, n, chip=chip) if chip is not None else None
    flops = 2.0 * A.nnz * k

    E = ell_pack(A).to(dev)
    out["ell_padding_factor"] = E.padded_nnz / max(A.nnz, 1)
    if b.gate("spmm_ell_k128", 90):
        ms = loop("spmm_ell_k128", ops.ell_spmm, E, B0)
        record("spmm_ell_k128", ms, flops, rl)
        if chip is not None:  # the gather rate of a table of B's size
            out["spmm_ell_k128_att_frac"] = round(
                spmm_attainable(E.padded_nnz, m, k, table_bytes=n * k * 4) / (ms * 1e-3), 4)
    if b.gate("spmv_ell", 60):
        ms = loop("spmv_ell", ops.ell_spmv, E, x0)
        record("spmv_ell", ms, 2.0 * A.nnz, rlv)
        if chip is not None:
            out["spmv_ell_att_frac"] = round(spmv_attainable(E.padded_nnz) / (ms * 1e-3), 4)
    if b.gate("bsr", 60):
        try:
            from spmm_tpu_torch.ops.bsr_kernel import bsr_spmm, bsr_spmv

            nb = bsr_shape[0]
            Bs = csr_to_bsr(banded_random(*bsr_shape, seed=3), (8, 128)).to(dev)
            Bd = torch.from_numpy(np.random.default_rng(2).standard_normal(
                (((nb + 127) // 128) * 128, 128)).astype(np.float32)).to(dev)
            out["bsr_nblocks"] = int(Bs.nblocks)
            ms = loop("bsr_spmm_k128", bsr_spmm, Bs, Bd)
            record("bsr_spmm_k128", ms, 2.0 * Bs.nblocks * 8 * 128 * 128)
            ms = loop("bsr_spmv", bsr_spmv, Bs, Bd[:, 0].contiguous())
            record("bsr_spmv", ms, 2.0 * Bs.nblocks * 8 * 128)
        except Exception as e:
            log("bsr bench failed:", traceback.format_exc())
            out["bsr_error"] = repr(e)[:200]
    if b.gate("spmm_ell_k32", 60):
        B32 = B0[:, :32].contiguous()
        ms = loop("spmm_ell_k32", ops.ell_spmm, E, B32)
        # no sol_frac: K2's cost is per-row gathers, nearly blind to k
        record("spmm_ell_k32", ms, 2.0 * A.nnz * 32)
        if chip is not None:
            out["spmm_ell_k32_att_frac"] = round(
                spmm_attainable(E.padded_nnz, m, 32, table_bytes=n * 32 * 4) / (ms * 1e-3), 4)
    del E

    # the dispatchers on the raw CSR: their memoized ELL pack (its one-time
    # host cost is spmv_csr_pack_ms), then the steady state
    from spmm_tpu_torch.ops.spmm import _ell_of

    out["spmv_csr_pack_ms"] = round(measure_host(lambda: ell_pack(A), name="ell_pack", iters=3).min_ms, 2)
    Ed = _ell_of(A, dev)
    if b.gate("spmv_csr", 60):
        ms = loop("spmv_csr", ops.ell_spmv, Ed, x0)
        record("spmv_csr", ms, 2.0 * A.nnz, rlv)
        out["spmv_csr_gnnz_per_s"] = round(A.nnz / (ms * 1e-3) / 1e9, 4)
    if full and b.gate("spmm_csr_k128", 60):
        record("spmm_csr_k128", loop("spmm_csr_k128", ops.ell_spmm, Ed, B0), flops, rl)
    del Ed

    if P is not None and b.gate("spmm_blocked_k128", 80):
        from spmm_tpu_torch.ops.blocked import blocked_slab_view, blocked_spmm_slab

        Pd = P.to(dev)
        view = blocked_slab_view(Pd)  # pack once, multiply many
        ms = loop("spmm_blocked_k128", lambda B: blocked_spmm_slab(Pd, B, view), B0)
        record("spmm_blocked_k128", ms, flops, rl)
        del Pd, view

    if full and b.gate("raw_csr", 120):  # the gather + ordered-sum path, no pack
        Ad = A.pad(128).to(dev)
        record("spmm_csr_raw_k128", loop("spmm_csr_raw_k128", ops.spmm_xla, Ad, B0), flops, rl)
        record("spmv_csr_raw", loop("spmv_csr_raw", ops.spmv_xla, Ad, x0), 2.0 * A.nnz, rlv)


def _spgemm_once(A, Ad, pattern: bool, W: int, classes) -> float:
    t0 = time.perf_counter()
    _cold_spgemm(A, Ad, pattern, W, classes)
    return (time.perf_counter() - t0) * 1e3


def bench_suite(b: Bench, cfg, device, suite=SUITE) -> None:
    """BASELINE.json configs 1-2 over the reference's suite (web-Google's
    own numbers come from the main sections): preprocess (min of 3) and the
    cold SpGEMM A×A (min of 2 after a first call) of each stand-in,
    ``webgraph_like(n, nnz, seed=1)``."""
    import torch

    from spmm_tpu_torch.formats import webgraph_like
    from spmm_tpu_torch.ops import slab_spgemm as ss

    dev = torch.device(device)
    W = ss.DEFAULT_SEG_W
    cl = ss._norm_classes(ss.DEFAULT_CLASSES, W)
    for name, (n, nnz) in suite.items():
        if name == "web-Google":
            continue
        if not b.gate(f"suite:{name}", 55):
            break
        A = webgraph_like(n, nnz, seed=1)
        pre_ms, _ = bench_preprocess(A, cfg, iters=3)
        b.result[f"{name}_preprocess_ms"] = round(pre_ms, 2)
        Ad, pattern = A.to(dev), ss._is_pattern(A)
        _spgemm_once(A, Ad, pattern, W, cl)
        ms = min(_spgemm_once(A, Ad, pattern, W, cl) for _ in range(2))
        b.result[f"{name}_spgemm_ms"] = round(ms, 2)
        log(f"suite {name}: preprocess {pre_ms:.1f} ms, spgemm {ms:.1f} ms")


def bench_dist_big(b: Bench, device, shape=DIST_BIG) -> None:
    """``parallel.spgemm_dist_big`` (BASELINE config 5's composition: the
    row-partitioned SpGEMM streamed in pieces) on one rank: NCCL at world
    size 1 on the card (gloo for ``device="cpu"``), the process group set up
    from a rendezvous environment made here and destroyed after.  One call,
    host clock; C's nnz must equal scipy's."""
    import torch
    import torch.distributed as dist

    from spmm_tpu_torch.formats import webgraph_like
    from spmm_tpu_torch.parallel import make_mesh, spgemm_dist_big
    from spmm_tpu_torch.parallel.mesh import free_port, initialize_distributed

    n, nnz, pieces = shape
    dev = torch.device(device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: spgemm_dist_big runs on its own")
    G = webgraph_like(n, nnz, seed=5)
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": str(dev.index or 0)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        initialize_distributed(device=dev)
        try:
            mesh = make_mesh(device=dev.type)
            _sync(dev)
            t0 = time.perf_counter()
            C = spgemm_dist_big(G, G, mesh, pieces=pieces)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    Gs = G.to_scipy()
    ref_nnz = int((Gs @ Gs).nnz)
    if int(C.nnz) != ref_nnz:
        raise RuntimeError(f"spgemm_dist_big: C has {C.nnz} nonzeros, scipy's {ref_nnz}")
    b.result["spgemm_dist_big_ms"] = round(ms, 2)
    b.result["spgemm_dist_big_nnz_out"] = int(C.nnz)
    b.result["spgemm_dist_big_mnnz_out_per_s"] = round(C.nnz / (ms * 1e-3) / 1e6, 2)
    b.result["spgemm_dist_big_pieces"] = int(pieces)
    log(f"spgemm_dist_big ({n} rows / {G.nnz / 1e6:.1f}M nnz, {pieces} pieces): {ms:.0f} ms -> "
        f"{C.nnz / 1e6:.1f}M out, equal to scipy's")


def bench_scaling(b: Bench, device, *, quick: bool = False) -> None:
    """The 1/2/4/8-rank scaling curve (``spmm_tpu_torch.utils.scaling``) on
    ``device`` as a subprocess, after the device sections (``bench.py``
    overlapped it with them): NCCL ranks, one card each, on the card; gloo
    ranks on the host's CPUs for ``device="cpu"``, which would take the
    cores that the other sections' enqueue and host work need."""
    sub_budget = max(45.0, min(500.0, b.time_left() - 90.0))
    cmd = [sys.executable, "-m", "spmm_tpu_torch.utils.scaling", "--budget", str(sub_budget),
           "--device", str(device.type)]
    if quick:
        cmd += ["--n", "12000", "--nnz", "72000", "--iters", "1"]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # its own session: its spawned ranks end with it (kill_group)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT,
                            start_new_session=True)
    b.children.append(proc)
    try:
        out_s, _ = proc.communicate(timeout=max(20.0, b.time_left() - 20.0))
    except subprocess.TimeoutExpired:
        kill_group(proc)
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"the scaling run exited {proc.returncode}")
    out = json.loads([ln for ln in out_s.strip().splitlines() if ln.startswith("{")][-1])
    log("scaling:", out)
    b.result.update(out)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="The port's one-JSON-line benchmark.")
    ap.add_argument("--quick", action="store_true", help="small matrix, fast run")
    ap.add_argument("--full", action="store_true",
                    help="also the dispatcher at k=128 and the raw-CSR gather path")
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--no-spgemm", action="store_true")
    ap.add_argument("--no-suite", action="store_true")
    ap.add_argument("--no-scaling", action="store_true")
    ap.add_argument("--matrix", default=None, metavar="PATH",
                    help="bench a real .mtx (pattern-ingested, the reference's contract) "
                    "instead of the synthetic web graph")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu (the plain versions)")
    return ap.parse_args(argv)


def run(b: Bench, args) -> None:
    import torch

    from spmm_tpu_torch.config import Config
    from spmm_tpu_torch.formats import webgraph_like
    from spmm_tpu_torch.formats.containers import compute_device

    dev = compute_device(args.device)  # first: without a card this raises at once
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    log(f"kernels built ({build_kernels(dev):.0f} ms)")
    n, nnz = (QUICK_N, QUICK_NNZ) if args.quick else (WEBGOOGLE_N, WEBGOOGLE_NNZ)
    t0 = time.perf_counter()
    if args.matrix:
        from spmm_tpu_torch.formats import read_mtx, to_csr

        A = to_csr(read_mtx(args.matrix))  # values forced to 1.0, as the reference ingests
        log(f"matrix {args.matrix}: {A.shape} nnz={A.nnz} ({time.perf_counter() - t0:.1f}s)")
    else:
        A = webgraph_like(n, nnz, seed=0)
        log(f"synthetic web graph: {A.shape} nnz={A.nnz} ({time.perf_counter() - t0:.1f}s)")

    cfg = Config()
    pre_ms, P = bench_preprocess(A, cfg)
    log(f"preprocess: {pre_ms:.1f} ms; the reference's rebuild: {REFERENCE_PREPROCESS_MS} ms")
    baseline_ms = REFERENCE_PREPROCESS_MS if not (args.quick or args.matrix) else float("nan")
    record_headline(b, A, pre_ms, P, baseline_ms)  # from here on every exit path prints it
    b.result.update(_card(dev))
    chip = chip_of(dev)

    def section(name: str, need_s: float, error_key: str, fn, *a, **kw):
        if not b.gate(name, need_s):
            return
        t = time.perf_counter()
        try:
            fn(*a, **kw)
        except Exception as e:  # the line keeps what the other sections measured
            log(f"{name} bench failed:", traceback.format_exc())
            b.result[error_key] = repr(e)[:200]
        log(f"section {name}: {time.perf_counter() - t:.1f} s")

    if not args.no_spgemm:
        section("spgemm", 150, "spgemm_error", bench_spgemm, b, A, dev, chip)
    if not args.no_kernels:
        section("kernels", 120, "kernel_error", bench_kernels, b, A, P, dev, chip, full=args.full)
    if not args.no_suite and not args.quick:
        section("suite", 110, "suite_error", bench_suite, b, cfg, dev)
    if not args.no_spgemm and not args.quick:
        section("dist_big", 120, "dist_big_error", bench_dist_big, b, dev)
    if not args.no_scaling:
        section("scaling", 90, "scaling_error", bench_scaling, b, dev, quick=args.quick)


def main(argv=None) -> int:
    args = parse_args(argv)
    b = Bench(float(os.environ.get("BENCH_BUDGET_S", "720")))
    b.install_handlers()
    try:
        run(b, args)
    except Exception as e:  # the line is printed on every exit path
        log(traceback.format_exc())
        b.result["error"] = repr(e)[:300]
    except BaseException as e:  # an interrupt: the line, then on out
        b.result["interrupted"] = type(e).__name__
        b.emit()
        raise
    b.emit()
    signal.alarm(0)
    return 1 if b.failed() else 0


if __name__ == "__main__":
    sys.exit(main())
