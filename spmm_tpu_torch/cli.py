"""CLI driver — reference-compatible batch preprocessing + compute on a torch
device (port of ``spmm_tpu/cli.py``).

Mirrors the reference's driver contract (reference:
serial_newblock_clock.cpp:501-599, README.md:11-24): run in a directory
containing ``matrix.txt`` (one matrix name per line) and
``mat/mtx/<name>/<name>.mtx``; writes ``<name> <preprocess_ms>ms`` lines to
``result.txt`` and a per-phase breakdown to stdout.  ``--spgemm`` / ``--spmm
K`` run the compute (SpMM through kernel K2 on the ELL pack, exact A×A
SpGEMM), ``--check`` verifies them against scipy, and ``--device`` picks the
torch device (default ``cuda``; there is no silent fallback to the CPU).

Usage:
  python -m spmm_tpu_torch.cli [--dir DIR] [--spgemm] [--spmm K] [--check] [--device DEV]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

#: --check bound on the SpMM error, relative to max |reference| (fp32 sums of
#: up to a few thousand terms, in another order than scipy's)
SPMM_CHECK_RTOL = 1e-4


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def process_matrix(path: str, args, device: torch.device) -> dict:
    from spmm_tpu_torch.config import Config
    from spmm_tpu_torch.formats.containers import to_csr
    from spmm_tpu_torch.formats.mtx import read_mtx
    from spmm_tpu_torch.preprocess import preprocess

    out = {"matrix": os.path.basename(path)}
    t0 = time.perf_counter()
    coo = read_mtx(path, values="pattern" if args.pattern else "native")
    A = to_csr(coo, sort_within_row=True, sum_duplicates=args.dedup)
    out["read_ms"] = (time.perf_counter() - t0) * 1e3
    out["shape"] = A.shape
    out["nnz"] = A.nnz

    cfg = Config(region_budget=args.region_budget, section_size=args.section_size)
    t0 = time.perf_counter()
    P = preprocess(A, cfg)
    out["preprocess_ms"] = (time.perf_counter() - t0) * 1e3
    out["regions"] = P.nregions
    out["v8_groups"] = P.ngroups
    checks = []

    if args.spmm:
        from spmm_tpu_torch.formats.ell import ell_pack
        from spmm_tpu_torch.ops.ell_spmm import ell_spmm

        k = args.spmm
        E = ell_pack(A).to(device)
        B_host = np.random.default_rng(0).standard_normal((A.shape[1], k)).astype(np.float32)
        B = torch.from_numpy(B_host).to(device)
        _sync(device)
        t0 = time.perf_counter()
        ell_spmm(E, B)  # first call: includes the kernel build on a GPU
        _sync(device)
        out["spmm_first_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        Y = ell_spmm(E, B)
        _sync(device)
        out["spmm_ms"] = (time.perf_counter() - t0) * 1e3
        if args.check:
            ref = A.to_scipy() @ B_host
            err = float(np.abs(Y.cpu().numpy() - ref).max()) if ref.size else 0.0
            out["spmm_max_err"] = err
            checks.append(err <= SPMM_CHECK_RTOL * max(1.0, float(np.abs(ref).max(initial=0.0))))

    if args.spgemm:
        from spmm_tpu_torch.ops import spgemm

        _sync(device)
        t0 = time.perf_counter()
        C = spgemm(A, A, device=device)
        _sync(device)
        out["spgemm_ms"] = (time.perf_counter() - t0) * 1e3
        out["spgemm_out_nnz"] = C.nnz
        if args.check:
            S = A.to_scipy()
            ref = (S @ S).tocsr()
            ref.sum_duplicates()
            ref.sort_indices()
            exact = (
                C.nnz == ref.nnz
                and np.array_equal(np.asarray(C.indptr), ref.indptr)
                and np.array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
            )
            out["spgemm_ref_nnz"] = int(ref.nnz)
            out["spgemm_exact"] = bool(exact)
            d = abs(C.to_scipy() - ref)
            out["spgemm_max_err"] = float(d.max()) if d.nnz else 0.0
            checks.append(exact)
    if args.check:
        out["check_ok"] = all(checks)
    return out


def main(argv=None, results: list | None = None) -> int:
    """Runs the CLI; returns 0, or 1 when a ``--check`` fails (2 on a
    missing ``matrix.txt``).  ``results``, when given, receives each matrix's
    dict, for callers that drive the CLI in-process."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default=".", help="directory with matrix.txt + mat/mtx/...")
    ap.add_argument("--matrix", help="single .mtx path (bypasses matrix.txt)")
    ap.add_argument("--pattern", action="store_true", default=True,
                    help="force values to 1.0 (reference parity; default)")
    ap.add_argument("--values", dest="pattern", action="store_false",
                    help="read real values from the file")
    ap.add_argument("--dedup", action="store_true", help="sum duplicate entries")
    ap.add_argument("--region-budget", type=int, default=65536)
    ap.add_argument("--section-size", type=int, default=2048)
    ap.add_argument("--spmm", type=int, metavar="K", help="run SpMM with a random (n, K) RHS")
    ap.add_argument("--spgemm", action="store_true", help="run SpGEMM A@A")
    ap.add_argument("--check", action="store_true", help="verify against scipy")
    ap.add_argument("--device", default="cuda", help="torch device for the compute (default cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu)")

    if args.matrix:
        paths = [args.matrix]
    else:
        mlist = os.path.join(args.dir, "matrix.txt")
        if not os.path.exists(mlist):
            print(f"no {mlist}; pass --matrix or --dir", file=sys.stderr)
            return 2
        with open(mlist) as f:
            names = [ln.split(".")[0].strip() for ln in f if ln.strip()]
        paths = [os.path.join(args.dir, "mat", "mtx", n, f"{n}.mtx") for n in names]

    out = []
    for p in paths:
        r = process_matrix(p, args, device)
        out.append(r)
        print("----name:%s----" % r["matrix"])  # reference stdout marker (:567)
        for k, v in r.items():
            print(f"  {k}: {v}")

    # result.txt: "<name> <time>ms" per matrix (reference :565)
    if not args.matrix:
        with open(os.path.join(args.dir, "result.txt"), "w") as f:
            for r in out:
                name = os.path.splitext(r["matrix"])[0]
                f.write(f"{name} {r['preprocess_ms']:.3f}ms\n")
    if results is not None:
        results.extend(out)
    return 0 if all(r.get("check_ok", True) for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
