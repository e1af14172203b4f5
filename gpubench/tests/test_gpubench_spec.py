"""Cells, configurations, traffic mixes, limits and metrics are found by
name: a new one is new files plus new BENCHMARK.json entries."""

import json
import os
import shutil

from gpubench import spec

from conftest import make_root


def test_added_files_are_found_by_name(tmp_path):
    root = make_root(str(tmp_path))
    bd = os.path.join(root, "gpubench")
    shutil.copy(os.path.join(bd, "configs", "tiny-pq.json"),
                os.path.join(bd, "configs", "new-config.json"))
    with open(os.path.join(bd, "traffic", "new-mix.json"), "w") as f:
        json.dump({"kind": "closed_loop", "batch": 64, "topn": 5,
                   "retrieval_params": {"nprobe": 3}}, f)
    with open(os.path.join(bd, "limits", "new-cell.json"), "w") as f:
        json.dump({"bad_answers": {"limit": 0}}, f)
    with open(os.path.join(bd, "metrics", "new_metric.x.py"), "w") as f:
        f.write("def read(rec):\n    return 2.0 * rec\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-mix", "chips": 1,
                               "why": "found by name"})
    bench["per_layer"].append({"name": "new_metric.x", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "engine", "moves": "qps",
                               "workloads": ["new-cell"]})
    # a per-cell quantity with no file of its own: metrics/<base>.py
    bench["per_layer"].append({"name": "search_p95_ms.new-cell",
                               "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "engine",
                               "moves": "qps", "workloads": ["new-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.load_cell("new-cell", root, bd)
    assert cell.config["name"] == "tiny-pq"
    assert cell.traffic["batch"] == 64 and cell.limits["bad_answers"]
    names = [m.name for m in cell.per_layer]
    # the others name other cells
    assert names == ["new_metric.x", "search_p95_ms.new-cell"]
    assert cell.per_layer[0].read(3.0) == 6.0
    assert not os.path.exists(os.path.join(
        bd, "metrics", "search_p95_ms.new-cell.py"))
    rec = type("Rec", (), {"latencies_s": [0.001] * 20})()
    assert abs(cell.per_layer[1].read(rec) - 1.0) < 1e-9
    assert cell.per_layer[0].unit == "ms"
    # a metric with no `workloads` key is every cell's
    assert {m.name for m in cell.end_to_end} == {
        m["name"] for m in bench["end_to_end"] if "workloads" not in m}


def test_real_cells_load():
    for name in ("vgg1m-dense-bulk", "sift1m-pq-bulk"):
        cell = spec.load_cell(name)
        assert cell.chips == 1
        assert {m.name for m in cell.end_to_end} >= {"qps", "setup_s"}
        assert cell.per_layer and cell.limits["bad_answers"]["limit"] == 0
