"""The readings that the limits of the comparison are set from: a cell's
numbers compared over many seeds of the program (each a short window at
the cell's own load), and over the control, the reference in the nearest
precision below the configuration's put in the program's place, in one
process so that the kernels load once.  A benchmark run never calls the
control.

    python3 -m portbench.readings --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 [--seconds 3]

Prints one JSON line per seed: ``{"who": "program"|"control", "seed", "checks"}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.judge import as_json

    cell = harness.load_cell(args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    for seed in ints(args.seeds):
        t = time.perf_counter()
        line = harness.run_cell(cell, seed, args.seconds, False, args.device)
        print(json.dumps(harness.finite({"who": "program", "seed": seed, "correct": line["correct"],
                                         "calls": line["attempted"], "checks": line["checks"],
                                         "s": time.perf_counter() - t})), flush=True)
    kind = cell.kind
    for seed in ints(args.control_seeds):
        t = time.perf_counter()
        state = kind.setup(cell.config, cell.traffic, seed, args.device)
        out = kind.control(state, args.device)
        kind.release(state)
        checks = kind.judge(state, [(0, out)], args.device)
        del out, state
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        print(json.dumps(harness.finite({"who": "control", "seed": seed, "checks": as_json(checks),
                                         "s": time.perf_counter() - t})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
