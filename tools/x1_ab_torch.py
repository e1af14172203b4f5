"""X1, the row gather of gamma_tpu_torch (csrc/gather_rows.cu), of this
tree against another tree's, on one card in one process.

Both sources are built with nvcc at the package's flags and loaded with
ctypes; each is held bit for bit against the plain version
(ops/gather_rows._gather_rows_plain) and then timed in turns, this
tree's and the other's alternately (other, this, this, other, once a
round), on the same operands:
  vgg-layout   D-vgg's X1 operand rebuilt: a 1,001,024 x 512 f32 table,
               25,600 candidates tiled 8 times (a batch of 2048 queries,
               256 repeated 8 times, recall 100), int64 indices;
  distinct-2k  204,800 distinct rows of the same table, int32;
  dense-bf16   chip_smoke.py's nominal X1 operand: 1M x 128 bf16 rows,
               102,400 int32 indices, some outside the table.
Each call is timed twice: by chip_smoke.device_time (its device events
in a profiler trace, the L2 flushed before every call) and by CUDA
events around 50 calls after the same flush-free warm-up.

Usage (on a machine with a CUDA card and nvcc):
    python3 tools/x1_ab_torch.py --other DIR [--rounds 2]
DIR is a checkout of the other tree, such as `git archive` of the parent
commit unpacked under build/.  Prints one JSON line per timing, then a
summary line per operand and tree; the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def build(trees):
    """{label: loaded library}: each tree's csrc/gather_rows.cu built
    under build/x1_ab/, one nvcc each, all started together."""
    from gamma_tpu_torch.ops import cuda_build
    out_dir = os.path.join(HERE, "build", "x1_ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for label, root in trees.items():
        src = os.path.join(root, "gamma_tpu_torch", "csrc", "gather_rows.cu")
        so = os.path.join(out_dir, f"{label}.so")
        procs[label] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{err}")
        lib = ctypes.CDLL(so)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.gather_rows.argtypes = [vp, ll, vp, i, vp, ll, i, i, vp]
        lib.gather_rows.restype = i
        libs[label] = lib
    return libs


def operands():
    """{name: (table, idx)} on the card, made from fixed seeds."""
    import torch
    import chip_smoke as cs
    g = torch.Generator(device="cuda").manual_seed(14)
    vgg = torch.randn((1_001_024, 512), generator=g, device="cuda")
    cand = torch.randint(0, vgg.shape[0], (25_600,), generator=g,
                         device="cuda")
    distinct = torch.randperm(vgg.shape[0], generator=g,
                              device="cuda")[:204_800].int()
    return {"vgg-layout": (vgg, cand.repeat(8)),
            "distinct-2k": (vgg, distinct),
            "dense-bf16": cs._x1_operands(80)}


def caller(lib, table, idx):
    """A call of `lib`'s gather_rows into a fresh output, as the wrapper
    (ops/gather_rows._launch) makes it."""
    import torch
    n, d = table.shape
    row_bytes = d * table.element_size()

    def call():
        out = torch.empty((idx.shape[0], d), dtype=table.dtype,
                          device=table.device)
        vec = (row_bytes % 16 == 0 and table.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
        rc = lib.gather_rows(
            ctypes.c_void_p(table.data_ptr()), n,
            ctypes.c_void_p(idx.data_ptr()), idx.element_size(),
            ctypes.c_void_p(out.data_ptr()), idx.shape[0], row_bytes,
            16 if vec else table.element_size(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"gather_rows launch failed: cudaError {rc}")
        return out
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other tree's checkout")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from gamma_tpu_torch.ops import gather_rows as x1
    if not torch.cuda.is_available():
        raise SystemExit("x1_ab_torch: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.mem",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    libs = build({"other": os.path.abspath(args.other), "this": HERE})
    summary = {}
    for name, (table, idx) in operands().items():
        ref = x1._gather_rows_plain(table, idx)
        for label, lib in libs.items():
            got = caller(lib, table, idx)()
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.uint8),
                               ref.view(torch.uint8)), (name, label)
        del got, ref
        for r in range(args.rounds):
            for label in ("other", "this", "this", "other"):
                call = caller(libs[label], table, idx)
                row = {"operand": name, "tree": label, "round": r,
                       "device_ms": cs.device_time(call),
                       "events_ms": cs.cuda_time(call, iters=50)}
                print(json.dumps(row), flush=True)
                summary.setdefault((name, label), []).append(row)
        torch.cuda.empty_cache()
    for (name, label), rows in summary.items():
        print("summary:", json.dumps({
            "operand": name, "tree": label,
            "device_ms": [r["device_ms"] for r in rows],
            "events_ms": [r["events_ms"] for r in rows]}))


if __name__ == "__main__":
    main()
