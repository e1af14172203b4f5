"""Read the numbers that decide `correct` over many seeds, and the
control's, in one process: the readings each limit is set from.

    python3 gpubench/readings.py --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 3]

Each seed is a whole run of the cell (set-up, a short window at the
cell's own load, the check) on the CUDA device; a control run serves the
same traffic from the engine the configuration's `control` describes
(its mirror one precision lower).  One JSON line per run, then a summary:
for each number the largest reading of the program and the smallest of
the control, and the control's runs that came out correct (none should).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from gpubench import harness, spec
    cell = spec.load_cell(args.workload)
    lower, upper, control_correct = {}, {}, []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            out = harness.run_cell(cell, seed, args.seconds, False,
                                   "cuda:0", t0, control=control)
            nums = {k: v["value"] for k, v in out["compared"].items()}
            print(json.dumps({"seed": seed, "control": control,
                              "correct": out["correct"],
                              "failed": out["failed"], "numbers": nums,
                              "metrics": {k: v["value"] for k, v
                                          in out["metrics"].items()},
                              "wall_s": time.perf_counter() - t0}),
                  flush=True)
            for k, v in nums.items():
                if control:
                    upper[k] = min(upper.get(k, v), v)
                else:
                    lower[k] = max(lower.get(k, v), v)
            if control and out["correct"]:
                control_correct.append(seed)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "control_correct": control_correct}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
