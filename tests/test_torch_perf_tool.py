"""tools/perf_torch.py, the port's QPS / latency sweep (the twin of
tools/perf.py), run whole on the CPU at a small size: its last line is
the JAX tool's JSON, every row with a positive QPS; its sweeps alone on
an engine of the caller's; and no fallback to the CPU when the card is
asked for and missing."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import perf_torch  # noqa: E402

ROW_KEYS = {"batch", "qps", "avg_ms", "tp90_ms", "tp99_ms"}


def test_main_on_the_cpu(tmp_path, capsys):
    perf_torch.main(["--n", "4096", "--d", "32", "--nq", "64",
                     "--threads", "4", "--filters", "--device", "cpu",
                     "--path", str(tmp_path / "eng")])
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert set(out) == {"rows", "ingest_docs_per_s"}
    assert out["ingest_docs_per_s"] > 0
    assert [r["batch"] for r in out["rows"]] == [1, 8, 32]
    for row in out["rows"]:
        assert set(row) == ROW_KEYS and row["qps"] > 0, row
    assert any(line.startswith("threads=4: QPS=") for line in lines)


def test_sweeps_on_an_engine(tmp_path):
    """The sweeps on an engine built by the caller, filtered: the rows
    and the thread sweep's record; a caller's exception is raised."""
    from gamma_tpu_torch import (Doc, EngineConfig, FieldInfo, GammaEngine,
                                 RangeFilter, Request, TableInfo,
                                 VectorInfo, VectorQuery)
    from gamma_tpu_torch.config import DataType
    x = np.random.default_rng(0).normal(size=(1500, 16)).astype(np.float32)
    eng = GammaEngine(EngineConfig(path=str(tmp_path)), device="cpu")
    eng.create_table(TableInfo(
        name="p", fields=[FieldInfo("price", DataType.FLOAT, True)],
        vectors=[VectorInfo("vec", 16)], indexing_size=1000,
        retrieval_types=["IVFPQ"],
        retrieval_params=[{"ncentroids": 16, "nsubvector": 8}]))
    eng.add_or_update_docs([Doc(key=f"k{i}", fields={"price": float(i)},
                                vectors={"vec": x[i]})
                            for i in range(1500)])
    eng.flush()

    def make_req(qb):
        return Request(topn=5, vec_fields=[VectorQuery("vec", qb)],
                       range_filters=[RangeFilter("price", 0.0, 700.0)])

    rows = perf_torch.batch_sweep(eng, x[:40], make_req, log=lambda s: None)
    assert [r["batch"] for r in rows] == [1, 8, 32]
    assert all(set(r) == ROW_KEYS and r["qps"] > 0 for r in rows)
    rec = perf_torch.thread_sweep(eng, x[:40], make_req, 3,
                                  log=lambda s: None)
    assert rec["threads"] == 3 and rec["qps"] > 0
    assert rec["p50_ms"] <= rec["tp99_ms"]

    def broken(qb):
        raise ValueError("bad request")

    with pytest.raises(ValueError, match="bad request"):
        perf_torch.thread_sweep(eng, x[:40], broken, 2, log=lambda s: None)
    eng.close()


def test_no_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf_torch.main(["--n", "1000", "--d", "32", "--nq", "8",
                         "--path", str(tmp_path / "eng")])
