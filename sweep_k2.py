#!/usr/bin/env python3
"""Sweep the design choices of K2 (``spmm_tpu_torch/csrc/ell_slab_spmm.cu``)
on one NVIDIA GPU, over the ELL pack of the web-Google-sized graph
(``webgraph_like(916_428, 5_105_039, seed=0)``):

- the work order: items in the original-row order ``ell_spmm`` gives K2,
  against heaviest first (the first design's order, given as row keys);
- the B-row loads in flight per lane (the kernel's ``kUnroll``) at each lane
  layout, k = 128, 64, 32, 8 and 1: the source's rule against fixed values;
- the split threshold of long rows (``work_table``'s ``split_l``) at k = 128
  and 32.

Each ``kUnroll`` variant is the kernel library built from the unchanged
sources with ``-DSPMM_K2_UNROLL=n`` into ``spmm_tpu_torch/_build/sweep/``
(the builds run side by side).  Every product is checked against the plain
version before it is timed (CUDA events, mean of 10).  Prints one line per k
and the card's name and power limit; exits nonzero without CUDA.

Usage: python3 sweep_k2.py
"""

from __future__ import annotations

import concurrent.futures
import os
import subprocess
import sys

import numpy as np
import torch

from spmm_tpu_torch import kernels
from spmm_tpu_torch.formats import ell_pack, webgraph_like
from spmm_tpu_torch.native.build import compile_if_stale
from spmm_tpu_torch.ops import ell_kernel
from spmm_tpu_torch.ops.ell_spmm import slab_row_keys

UNROLLS = (2, 4, 8, 16)
SPLITS = (32, 64, 128, 1 << 30)


def _variant(unroll: int) -> str:
    """The kernel library with ``kUnroll`` fixed at ``unroll``."""
    lib = os.path.join(os.path.dirname(kernels.LIB), "sweep", f"unroll{unroll}", "lib.so")
    return compile_if_stale(kernels.sources(), lib,
                            [kernels.nvcc(), *kernels.NVCC_FLAGS, f"-DSPMM_K2_UNROLL={unroll}"],
                            force=True)


def heaviest_first_keys(shapes, tpr_log2: int) -> np.ndarray:
    """Row keys under which ``work_table`` runs the heaviest items first,
    slab by slab among equals: each row keyed by minus its item's work (L,
    or the chunk of a split row)."""
    meta, _ = ell_kernel.work_table(shapes, tpr_log2)
    work = np.where(meta[:, 3] > 0, meta[:, 3], meta[:, 0])
    return np.repeat(-work, meta[:, 1])


def _ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_k2: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    with concurrent.futures.ThreadPoolExecutor(len(UNROLLS) + 1) as ex:
        built = ex.submit(kernels.build)
        variants = dict(zip(UNROLLS, ex.map(_variant, UNROLLS)))
        built.result()
    libs = {u: kernels.load(path) for u, path in variants.items()}
    main_lib = kernels.lib()

    A = webgraph_like(916_428, 5_105_039, seed=0)
    E = ell_pack(A).to(dev)
    shapes = [tuple(c.shape) for c in E.cols]
    keys = slab_row_keys(E)
    rows = sum(R for R, _ in shapes)
    rng = np.random.default_rng(0)

    def timed(so, table, B, out, ref, vec, tpr_log2):
        def run():
            err = so.ell_slabs_spmm_launch(
                table.slabs.data_ptr(), table.items.data_ptr(), table.items.shape[0],
                table.data_code, B.data_ptr(), kernels.F32, out.data_ptr(), B.shape[0],
                B.shape[1], vec, tpr_log2, kernels.stream_ptr(dev))
            kernels.check(err, "sweep_k2")

        out.fill_(float("nan"))
        run()
        torch.cuda.synchronize()
        rel = float((out - ref).abs().max()) / float(ref.abs().max())
        if not rel <= 1e-5:
            raise SystemExit(f"sweep_k2: a variant differs from the plain version (rel {rel:.3e})")
        return _ms(run)

    for k in (128, 64, 32, 8, 1):
        B = torch.from_numpy(rng.standard_normal((A.shape[1], k)).astype(np.float32)).to(dev)
        out = torch.empty((rows, k), device=dev)
        ref = ell_kernel.ell_slabs_spmm_reference(E.cols, E.data, B, torch.empty_like(out))
        vec, tpr_log2 = ell_kernel.lane_layout(k, True)
        keyed = ell_kernel._slab_table(E.cols, E.data, dev, tpr_log2, keys)
        heavy = ell_kernel._slab_table(E.cols, E.data, dev, tpr_log2, heaviest_first_keys(shapes, tpr_log2))
        rule = 4 if tpr_log2 >= 4 or tpr_log2 == 0 else 8
        line = (f"k={k} ({1 << tpr_log2} lanes a row): source (kUnroll {rule}) in key order "
                f"{timed(main_lib, keyed, B, out, ref, vec, tpr_log2):.4f} ms, heaviest first "
                f"{timed(main_lib, heavy, B, out, ref, vec, tpr_log2):.4f} ms | key order with kUnroll ")
        line += ", ".join(f"{u}: {timed(so, keyed, B, out, ref, vec, tpr_log2):.4f}" for u, so in libs.items())
        if k in (128, 32):
            cells = []
            for s in SPLITS:
                t = ell_kernel._slab_table(E.cols, E.data, dev, tpr_log2, keys, split_l=s)
                cells.append(f"{s if s < 1 << 30 else 'none'}: {timed(main_lib, t, B, out, ref, vec, tpr_log2):.4f}")
            line += " | split threshold " + ", ".join(cells)
        print(line + " ms", flush=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
