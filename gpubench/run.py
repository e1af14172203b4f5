"""Run one cell of BENCHMARK.json on this machine's GPU.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`; `notes`: the window's requests and
seconds, set-up's parts, the garbage collections in each window; last
`compared`: each number the check compared with its limit); the
compared numbers are also the last lines of standard error.  Without a
CUDA device, or with fewer than the cell asks for, or with jax, jaxlib,
flax or gamma_tpu loaded once the window has closed, it prints no result
and exits with a code other than 0.
The program builds its kernels into build/gamma_tpu_torch/ inside the
checkout, a fixed place, so only a checkout's first run compiles.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gamma_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, device=None, root=ROOT) -> int:
    """`device` and `root` are for tests: a device given skips the look
    for CUDA devices, and the cell is read from `root`'s BENCHMARK.json
    and gpubench/."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from gpubench import harness, spec
    cell = spec.load_cell(args.workload, root,
                          os.path.join(root, "gpubench"))
    t0 = T0 if device is None else time.perf_counter()
    if device is None:
        have = (torch.cuda.device_count() if torch.cuda.is_available()
                else 0)
        if have < cell.chips:
            print(f"gpubench: {args.workload} needs {cell.chips} CUDA "
                  f"device(s), found {have}", file=sys.stderr)
            return 2
        device = "cuda:0"
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device, t0)
    found = forbidden_modules()
    if found:
        print(f"gpubench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"gpubench: {json.dumps(out['notes'])}", file=sys.stderr)
    for name, v in out["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
