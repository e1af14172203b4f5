"""A tiny cell end to end on the CPU, through run.py's main."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _main(root, workload, trace, seed=2**31 + 17):
    from gpubench import run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "1", "--trace", str(trace)],
                      device="cpu", root=root)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["tiny-pq-bulk", "tiny-dense-bulk"])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_prints_one_result_line(tiny_root, workload, trace):
    out = _main(tiny_root, workload, trace)
    assert list(out) == KEYS + (["breakdown"] if trace else []) + [
        "notes", "compared"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind]
            if workload in m.get("workloads", [workload])}
    # device metrics need a device trace; the CPU has none
    cpu_silent = {"dense_scan_roofline", "gather_scan_roofline",
                  "device_idle_share"}
    assert set(out["metrics"]) == want - cpu_silent
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["breakdown"]["idle_gaps"]
    for v in out["compared"].values():
        assert set(v) == {"value", "limit"}


def test_without_cuda_no_result(tmp_path):
    """Run as the benchmark's command: no CUDA device here, so a code
    other than 0 and nothing on standard output."""
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "vgg1m-dense-bulk", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and gpubench/."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        "sift1m-pq-bulk", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
