#!/usr/bin/env python3
"""Where the time of the backward routes and of the examples' SpMV step goes,
on one NVIDIA GPU (CUDA events, mean of 10, through the package's
``utils.timing.measure``; per-kernel device time through
``utils.profiling.profile_fn``).  Beside ``chip_smoke.py``, which times each
route whole, this script times the pieces, at web-Google size
(``webgraph_like(916_428, 5_105_039, seed=0)``):

1. grad B of ``ell_spmm``, ``ops.ell_slabs_spmm_transposed`` with the
   forward's row map, at k = 128 and 32 and at three cut lengths of the
   transposed pack's long rows: the whole route, the host's enqueue time,
   the values' concatenation, K2 alone (with its row map and value index, in
   the pack's row-key order and slab by slab), the empty rows' fill and the
   cut rows' join; then a profile of the route at the shipped cut.
2. one ``ell_spmv`` with PageRank's operator (Pᵀ packed by ``ell_pack``,
   whose rows longer than 2,048 are leftover rows) beside one with A's pack
   (no leftover rows), and a profile of the first.
3. triangle counting (``examples/triangle_count_torch.py``) on the
   symmetrised ``webgraph_like(n, 6 n, seed=0)`` at growing n: the largest
   degree, the partial products and output nonzeros of A×A, the product's
   and the host join's time, the device time inside the product, the host
   functions that take the rest (cProfile), and scipy's time for the same
   masked product.

Usage: python3 probe_backward.py [grad] [spmv] [triangles[=n1,n2,...]]
       (all three parts when none is named; builds the kernels at first use)
"""

from __future__ import annotations

import cProfile
import importlib.util
import os
import pstats
import subprocess
import sys
import time

import numpy as np


def triangles(sizes) -> None:
    """Part 3: where triangle counting's time goes as the hub grows."""
    from spmm_tpu_torch import ops
    from spmm_tpu_torch.formats import webgraph_like
    from spmm_tpu_torch.ops.spgemm import spgemm_expand_bound
    from spmm_tpu_torch.utils.profiling import profile_fn

    spec = importlib.util.spec_from_file_location("triangle_count_torch", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "examples", "triangle_count_torch.py"))
    tri = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tri)
    for n in sizes:
        U = tri.symmetrize(webgraph_like(n, 6 * n, seed=0))
        deg = np.diff(np.asarray(U.indptr, np.int64))
        st = {}
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        count = prof.runcall(tri.count_triangles, U, stats=st)
        t_all = (time.perf_counter() - t0) * 1e3
        rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:8]  # by own time
        host = ", ".join(f"{os.path.basename(f)}:{line} {name} {tt * 1e3:.0f}" for (f, line, name), (_, _, tt, _, _) in rows)
        p = profile_fn(lambda: ops.spgemm(U, U), repeats=1, warm=False)
        Su = U.to_scipy()
        t0 = time.perf_counter()
        C = Su @ Su
        t_mul = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = float(C.multiply(Su).sum()) / 6.0
        t_mask = (time.perf_counter() - t0) * 1e3
        top = ", ".join(f"{o.name[:48]} {o.ms:.1f}" for o in p.ops[:4])
        print(f"triangles n={n}: {U.nnz // 2} edges, largest degree {int(deg.max())}, "
              f"{spgemm_expand_bound(U, U)} partial products, A×A {st['out_nnz']} nnz | count_triangles "
              f"{t_all:.1f} ms: ops.spgemm with its copy to the host {st['spgemm_ms']:.1f}, host join "
              f"{st['join_ms']:.1f} | device busy inside one more ops.spgemm {p.total_device_ms:.1f} ms: "
              f"{top} | host functions by own time (ms, cProfile over count_triangles): {host} | scipy: A×A {t_mul:.1f} ms, mask + sum {t_mask:.1f} | {count:.0f} triangles, "
              f"scipy {ref:.0f}", flush=True)
        del C, Su, U


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_backward: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from spmm_tpu_torch.formats import ell_pack, webgraph_like
    from spmm_tpu_torch.ops import ell_kernel as ek
    from spmm_tpu_torch.ops.ell_spmm import ell_spmv
    from spmm_tpu_torch.ops.transform import row_sums, scale_rows, transpose
    from spmm_tpu_torch.utils.profiling import profile_fn
    from spmm_tpu_torch.utils.timing import measure

    parts = {a.split("=")[0]: a.partition("=")[2] for a in sys.argv[1:]} or dict.fromkeys(
        ("grad", "spmv", "triangles"), "")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)

    def ms(fn, iters=10):
        return measure(fn, warmup=2, iters=iters, cuda=True).mean_ms

    def host_ms(fn, iters=20):
        """Host time to enqueue one call (no synchronize inside the loop)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        return t

    n = 916_428
    A = webgraph_like(n, 5_105_039, seed=0)
    E = ell_pack(A).to(dev)
    rng = np.random.default_rng(0)
    shipped = ek.T_CUT
    out_rows = torch.from_numpy(np.asarray(E.perm)[E.n_empty : n - E.n_rest_rows]).to(dev, torch.int32)
    key = ("transposed", dev, n, "rows")
    for k in (128, 32) if "grad" in parts else ():
        dY = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dev)  # ell_spmm's dY
        for cut in (512, shipped, 8192):
            T = ek.transposed_slabs(E.cols, n, dev, cut=cut, out_rows=out_rows)
            memo = {key: T}
            route = lambda: ek.ell_slabs_spmm_transposed(E.cols, E.data, dY, n, memo=memo, out_rows=out_rows)
            vals = ek.flat_values(E.data, T.bufs)
            y = torch.empty((T.out_size, k), device=dev)

            def k2(order=True):
                ek._k2_launch(T.cols, T.vidx, dY, y, T.memo if order else {}, T.row_keys if order else None,
                              out_rows=T.out_rows, values=vals)

            print(f"grad B k={k} cut={cut}: {len(T.cols)} slabs, {T.rows} slab rows, {T.hub_rows.numel()} rows "
                  f"cut into up to {T.hub_idx.shape[1]} pieces ({T.scratch} scratch rows) | whole route "
                  f"{ms(route):.4f} ms | host enqueue {host_ms(route):.4f} | values' concatenation "
                  f"{ms(lambda: ek.flat_values(E.data, T.bufs)):.4f} | K2 alone {ms(k2):.4f} | K2 alone, slab by slab "
                  f"{ms(lambda: k2(False), 3):.4f} | empty rows' fill "
                  f"{ms(lambda: y[:n].index_fill_(0, T.empty_rows, 0)):.4f} | cut rows' join "
                  f"{ms(lambda: y[T.hub_idx].sum(1)):.4f}", flush=True)
        T = ek.transposed_slabs(E.cols, n, dev, out_rows=out_rows)
        memo = {key: T}
        print(profile_fn(lambda: ek.ell_slabs_spmm_transposed(E.cols, E.data, dY, n, memo=memo,
                                                              out_rows=out_rows),
                         repeats=3).top(8), flush=True)

    if "triangles" in parts:
        triangles([int(v) for v in parts["triangles"].split(",")] if parts["triangles"]
                  else [16_384, 32_768])
    if "spmv" not in parts:
        return 0
    d = row_sums(A)
    P = scale_rows(A, np.where(d == 0, 0.0, 1.0 / np.maximum(d, 1e-30)))
    Pt = ell_pack(transpose(P)).to(dev)
    x = torch.full((n,), 1.0 / n, device=dev)
    print(f"PageRank's operator: {len(Pt.cols)} slabs, {Pt.n_rest_rows} leftover rows holding "
          f"{Pt.rest.nnz} nnz | ell_spmv {ms(lambda: ell_spmv(Pt, x)):.4f} ms, host enqueue "
          f"{host_ms(lambda: ell_spmv(Pt, x)):.4f} | ell_spmv over A's pack (no leftover rows) "
          f"{ms(lambda: ell_spmv(E, x)):.4f} ms, host enqueue {host_ms(lambda: ell_spmv(E, x)):.4f}")
    print(profile_fn(lambda: ell_spmv(Pt, x), repeats=3).top(8))
    return 0


if __name__ == "__main__":
    sys.exit(main())
