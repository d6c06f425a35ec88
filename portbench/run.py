"""Run one cell of ``BENCHMARK.json`` once on the card and print its result
as the last line of standard output (the numbers compared, beside their
limits, as the last lines of standard error).

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits nonzero, printing no result, without enough CUDA devices, when the
program (``spmm_tpu_torch``) is not in this checkout, or when the process
holds ``jax``, ``jaxlib``, ``flax`` or ``spmm_tpu`` once the window has
closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    try:
        import spmm_tpu_torch
    except ImportError as e:
        print(f"portbench: the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    where = os.path.dirname(os.path.dirname(os.path.abspath(spmm_tpu_torch.__file__)))
    if where != harness.ROOT:
        print(f"portbench: spmm_tpu_torch comes from {where}, not from this checkout {harness.ROOT}",
              file=sys.stderr)
        return 2

    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    for text in harness.check_lines(line):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.finite(line)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
