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
              bf16; K2 (ELL slab) on every slab of the ELL pack of
              ``webgraph_like(916_428, 5_105_039, seed=0)`` (web-Google size)
              at k=128 and k=32.  Max relative error and kernel/plain ms.
4. main     — the port's main path with every launch counter at 0: the CLI
              (.mtx ingest → preprocess → ELL SpMM k=128 → exact A×A SpGEMM,
              --check against scipy) on the web-Google-sized graph, then the
              SpMM dispatcher on the BSR and CSR forms.  Requires exact C
              structure, SpMM within tolerance, and every kernel launched.
5. report   — one JSON line of per-kernel results, the card's name and power
              limit, and the final ``{"ok": true, ...}`` line.

Any failure stops the run with a nonzero exit and no result line.  There is
no CPU path: without CUDA, or without the rest of the repository beside this
file, it exits nonzero.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
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


def max_errs(y, ref):
    err = float((y - ref).abs().max()) if y.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    return err, err / max(scale, 1e-30)


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
    t0 = time.perf_counter()
    A_band = banded_random(65536, 512, 0.25, seed=3)
    Ab = csr_to_bsr(A_band).to(dev)
    B_band = torch.from_numpy(rng.standard_normal((A_band.shape[1], 128)).astype(np.float32)).to(dev)
    say(f"phase 3 setup: BSR {A_band.shape} nnz {A_band.nnz} blocks {Ab.nblocks} "
        f"({(time.perf_counter() - t0) * 1e3:.1f} ms host)")
    for name, A_, B_, rtol in (
        ("fp32", Ab, B_band, RTOL_F32),
        ("bf16", dataclasses.replace(Ab, data=Ab.data.bfloat16()), B_band.bfloat16(), RTOL_BF16),
    ):
        y = ops.spmm(A_, B_)
        ref = bsr_kernel.bsr_spmm_reference(A_, B_)
        torch.cuda.synchronize()
        err, rel = max_errs(y, ref)
        ms = cuda_ms(torch, lambda: ops.spmm(A_, B_))
        plain = cuda_ms(torch, lambda: bsr_kernel.bsr_spmm_reference(A_, B_), iters=5)
        say(f"phase 3 K1 bsr_spmm {name} k=128: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
            f"(tol {rtol:g}) | kernel {ms:.4f} ms | plain {plain:.4f} ms")
        require(rel <= rtol, f"K1 {name} differs from its plain version: rel {rel:.3e}")
        if name == "fp32":
            results["bsr_spmm"] = dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain)

    t0 = time.perf_counter()
    A_web = webgraph_like(WEB_N, WEB_NNZ, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    E = ell_pack(A_web).to(dev)
    t_pack = time.perf_counter() - t0
    say(f"phase 3 setup: webgraph {A_web.shape} nnz {A_web.nnz} ({t_gen * 1e3:.1f} ms host) | "
        f"ELL {len(E.data)} slabs, padded nnz {E.padded_nnz}, rest rows {E.n_rest_rows} "
        f"({t_pack * 1e3:.1f} ms pack)")
    slabs = list(zip(E.cols, E.data))
    for k in (128, 32):
        Bw = torch.from_numpy(rng.standard_normal((WEB_N, k)).astype(np.float32)).to(dev)
        err = rel = 0.0
        for c, d in slabs:
            e_abs, e_rel = max_errs(ell_kernel.ell_slab_spmm(c, d, Bw),
                                    ell_kernel.ell_slab_spmm_reference(c, d, Bw))
            err, rel = max(err, e_abs), max(rel, e_rel)

        def run_kernel():
            for c, d in slabs:
                ell_kernel.ell_slab_spmm(c, d, Bw)

        def run_plain():
            for c, d in slabs:
                ell_kernel.ell_slab_spmm_reference(c, d, Bw)

        ms = cuda_ms(torch, run_kernel)
        plain = cuda_ms(torch, run_plain, iters=5)
        say(f"phase 3 K2 ell_slab_spmm fp32 k={k} ({len(slabs)} slabs): max_abs_err {err:.3e} "
            f"max_rel_err {rel:.3e} (tol {RTOL_F32:g}) | kernel {ms:.4f} ms | plain {plain:.4f} ms")
        require(rel <= RTOL_F32, f"K2 k={k} differs from its plain version: rel {rel:.3e}")
        if k == 128:
            results["ell_slab_spmm"] = dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain)
        del Bw

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
        t0 = time.perf_counter()
        rows: list = []
        rc = cli.main(["--dir", tmp, "--spgemm", "--spmm", "128", "--check", "--device", "cuda"],
                      results=rows)
        y_csr = ops.spmm(A_web, B_csr)
        y_bsr = ops.spmm(Ab, B_band)
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

    # ---- 5. report ---------------------------------------------------------
    replaces = {
        "bsr_spmm": ("spmm_tpu_torch/csrc/bsr_spmm.cu", "spmm_tpu/ops/pallas_bsr.py:38"),
        "ell_slab_spmm": ("spmm_tpu_torch/csrc/ell_slab_spmm.cu", "spmm_tpu/ops/pallas_ell.py:82"),
    }
    report = [
        {"name": kname, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[kname], **results[kname]}
        for kname, (src, rep) in replaces.items()
    ]
    say(json.dumps({"kernels": report}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
