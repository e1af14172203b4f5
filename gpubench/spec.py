"""Find a cell's files by the names BENCHMARK.json gives.

A cell (an entry of `workloads`) names a configuration and a traffic
mix; each lives in a file of its own (`configs/<config>.json`,
`traffic/<traffic>.json`), its correctness limits in
`limits/<workload>.json`, and every metric in `metrics/<metric>.py`, a
module with `read(rec) -> float | None`; a metric named `<base>.<part>`
with no file of its own (one quantity per cell, say) is read by
`metrics/<base>.py`.  A new cell, configuration,
mix or metric is new files plus new entries: no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable[[Any], Optional[float]]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_reader(bench_dir: str, name: str) -> Callable:
    """metrics/<name>.py's `read`, or, where there is none, that of
    metrics/<name up to its last dot>.py (names may hold dots, so the
    module is loaded from its file, not imported by name)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(bench_dir, "metrics",
                            f"{name.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(entries, workload: str, bench_dir: str):
    return [Metric(m["name"], m["unit"], load_reader(bench_dir, m["name"]))
            for m in entries
            if workload in m.get("workloads", [workload])]


def load_cell(workload: str, root: str = ROOT,
              bench_dir: str = HERE) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[workload]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_json(os.path.join(bench_dir, "configs",
                                  f"{w['config']}.json")),
        traffic=_json(os.path.join(bench_dir, "traffic",
                                   f"{w['traffic']}.json")),
        limits=_json(os.path.join(bench_dir, "limits", f"{workload}.json")),
        end_to_end=_metrics(bench["end_to_end"], workload, bench_dir),
        per_layer=_metrics(bench["per_layer"], workload, bench_dir))
