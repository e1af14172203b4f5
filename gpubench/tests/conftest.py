"""Tiny cells of the benchmark for CPU tests, in a root of their own.

`tiny_root` copies gpubench/ and BENCHMARK.json into a temporary root and
adds two small cells built from the real configurations with smaller
sizes (the widths and scan paths of the real cells, at 20,000 rows):
`tiny-pq-bulk` (bf16 mirror, gather over the PQ payload) and
`tiny-dense-bulk` (float32 mirror, the dense scan).  Their limits were
read on the CPU: the program's readings over a dozen seeds and the
control's, as the real cells' limits were on the card.

Tests that need a CUDA device carry the `cuda` mark and skip here; the
decision is taken in the `cuda_device` fixture, never at import.
"""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "tiny-pq": ("sift1m-ivfpq", {"n": 20000, "d": 32, "clusters": 64,
                                 "intrinsic": 8, "noise": 0.05},
                {"ncentroids": 64, "nsubvector": 8, "nprobe": 8}, 16384),
    "tiny-dense": ("vgg1m-ivfpq", {"n": 20000, "d": 64, "clusters": 64,
                                   "intrinsic": 12, "noise": 0.05},
                   {"ncentroids": 64, "nsubvector": 16, "nprobe": 8}, 16384),
}
TINY_CELLS = {"tiny-pq-bulk": ("tiny-pq", "bulk-gather", "sift1m-pq-bulk"),
              "tiny-dense-bulk": ("tiny-dense", "bulk-dense",
                                  "vgg1m-dense-bulk")}
# CPU readings, 12 seeds of the program (largest) / 3 of the control
# (smallest): tiny-pq score_gap 0.0198 / 0.213, recall_gap 0.0074 /
# 0.0775; tiny-dense score_gap 1.93e-7 / 0.00726 (recall_gap 0 / 0.0050:
# no lower reading to set a limit above, so not compared)
TINY_LIMITS = {"tiny-pq-bulk": {"score_gap": 0.06, "recall_gap": 0.025},
               "tiny-dense-bulk": {"score_gap": 1e-5}}
TINY_BATCH = 128


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device (runs on the card)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return "cuda:0"


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(dest: str) -> str:
    """A root holding BENCHMARK.json and gpubench/ with the tiny cells."""
    bd = os.path.join(dest, "gpubench")
    shutil.copytree(BENCH, bd, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, (base, corpus, params, isz) in TINY.items():
        with open(os.path.join(bd, "configs", f"{base}.json")) as f:
            cfg = json.load(f)
        cfg.update(name=name, corpus=corpus, indexing_size=isz,
                   queries={"pool": 512, "noise": 0.5})
        cfg["retrieval_params"].update(params)
        cfg["search_params"]["nprobe"] = params["nprobe"]
        _write(os.path.join(bd, "configs", f"{name}.json"), cfg)
    for cell, (cfg, traffic, real) in TINY_CELLS.items():
        with open(os.path.join(bd, "traffic", f"{traffic}.json")) as f:
            t = json.load(f)
        t["batch"] = TINY_BATCH
        _write(os.path.join(bd, "traffic", f"tiny-{traffic}.json"), t)
        limits = {"bad_answers": {"limit": 0}}
        limits.update({k: {"limit": v} for k, v in TINY_LIMITS[cell].items()})
        _write(os.path.join(bd, "limits", f"{cell}.json"), limits)
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": f"tiny-{traffic}", "chips": 1,
                                   "why": "a CPU test's cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    _write(os.path.join(dest, "BENCHMARK.json"), bench)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("gpubench_root")))
