"""QPS / latency sweep of the PyTorch/CUDA port (gamma_tpu_torch).

The port's twin of tools/perf.py, itself after the reference's
tools/perf.cc: ingest, build_index, then a batch-size sweep (batch 1, 8,
32, 128, 256, 512, stopping when QPS goes flat, perf.cc:306) and an
optional caller-thread sweep over the concurrent-request path, with a
range filter on request.  The engine runs on the card unless `--device
cpu` asks for the CPU; without a card the default raises.

Usage:
    python tools/perf_torch.py [--n 100000] [--d 128] [--model IVFPQ]
                               [--topn 10] [--nq 2048] [--filters]
                               [--path DIR] [--threads 0] [--device cuda]
Prints one table row per step; the last line is JSON: `rows` (batch,
qps, avg_ms, tp90_ms, tp99_ms) and `ingest_docs_per_s`.

`batch_sweep` and `thread_sweep` take any engine, its queries and a
request builder, so other scripts (chip_smoke.py) run them on their own
engines.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BATCHES = (1, 8, 32, 128, 256, 512)
PER_THREAD = 16          # single-query searches each caller thread makes


def pct(xs, p):
    return float(np.percentile(np.asarray(xs), p))


def _synced(eng):
    """A function that waits for the engine's device queue to drain
    (nothing on the CPU).  Called before a timed search starts, so the
    search's clock counts no earlier work; its end needs no call: the
    response holds host numpy, so the engine has synchronized already."""
    import torch
    if eng.device.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def batch_sweep(eng, queries, make_req, log=print):
    """Search `queries` in batches of each width of BATCHES until QPS
    goes flat (under 2% better from batch 128 on, perf.cc:306); each
    width sends len(queries) queries.  Returns the rows: batch, qps,
    avg_ms, tp90_ms, tp99_ms (host clock)."""
    nq = queries.shape[0]
    sync = _synced(eng)
    rows, best = [], 0.0
    log(f"{'batch':>6} {'QPS':>12} {'avg_ms':>8} {'tp90':>8} {'tp99':>8}")
    for bs in BATCHES:
        if bs > nq:
            break
        eng.search(make_req(queries[:bs]))         # warm-up
        lats, done = [], 0
        sync()
        t_all = time.perf_counter()
        while done < nq:
            qb = queries[done % (nq - bs + 1):][:bs]
            sync()
            t0 = time.perf_counter()
            eng.search(make_req(qb))
            lats.append((time.perf_counter() - t0) * 1000)
            done += bs
        qps = done / (time.perf_counter() - t_all)
        row = {"batch": bs, "qps": round(qps, 1),
               "avg_ms": round(float(np.mean(lats)), 3),
               "tp90_ms": round(pct(lats, 90), 3),
               "tp99_ms": round(pct(lats, 99), 3)}
        rows.append(row)
        log(f"{bs:>6} {row['qps']:>12,.0f} {row['avg_ms']:>8.2f} "
            f"{row['tp90_ms']:>8.2f} {row['tp99_ms']:>8.2f}")
        if qps < best * 1.02 and bs >= 128:
            break
        best = max(best, qps)
    return rows


def thread_sweep(eng, queries, make_req, threads, log=print):
    """`threads` caller threads, PER_THREAD single-query searches each,
    all at once (the batcher may coalesce them).  Returns threads, qps,
    avg_ms, p50_ms, tp90_ms, tp99_ms (host clock).  A caller's exception
    is raised here, after every thread has ended."""
    nq = queries.shape[0]
    # warm the batcher on every pow2 coalesced width the callers can form
    # (the JAX tool warms them because each is a fresh XLA compile; here
    # nothing compiles, the first searches only allocate)
    b = 1
    while b <= threads:
        eng.search(make_req(queries[:b]))
        b *= 2
    _synced(eng)()
    lats, errors, lock = [], [], threading.Lock()

    def worker(tid):
        local = []
        try:
            for i in range(PER_THREAD):
                qb = queries[(tid * PER_THREAD + i) % nq][None, :]
                t0 = time.perf_counter()
                eng.search(make_req(qb))
                local.append((time.perf_counter() - t0) * 1000)
        except Exception as exc:       # noqa: BLE001 - re-raised below
            errors.append(exc)
        with lock:
            lats.extend(local)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    row = {"threads": threads, "qps": round(threads * PER_THREAD / wall, 1),
           "avg_ms": round(float(np.mean(lats)), 3),
           "p50_ms": round(pct(lats, 50), 3),
           "tp90_ms": round(pct(lats, 90), 3),
           "tp99_ms": round(pct(lats, 99), 3)}
    log(f"threads={threads}: QPS={row['qps']:,.0f} "
        f"tp99={row['tp99_ms']:.2f} ms")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--model", default="IVFPQ")
    ap.add_argument("--topn", type=int, default=10)
    ap.add_argument("--nq", type=int, default=2048)
    ap.add_argument("--filters", action="store_true")
    ap.add_argument("--path", default=os.path.join(tempfile.gettempdir(),
                                                   "gamma_perf_torch"))
    ap.add_argument("--threads", type=int, default=0,
                    help="also run a caller-thread sweep at this many "
                         "threads (0 = skip)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (default; raises "
                         "without a card) or cpu")
    args = ap.parse_args(argv)

    from gamma_tpu_torch import (Doc, EngineConfig, FieldInfo, GammaEngine,
                                 RangeFilter, Request, TableInfo,
                                 VectorInfo, VectorQuery)
    from gamma_tpu_torch.config import DataType

    shutil.rmtree(args.path, ignore_errors=True)
    eng = GammaEngine(EngineConfig(path=args.path), device=args.device)
    nlist = max(64, min(2048, args.n // 256))
    eng.create_table(TableInfo(
        name="perf",
        fields=[FieldInfo("price", DataType.FLOAT, True)],
        vectors=[VectorInfo("vec", args.d)],
        indexing_size=args.n + 1,      # manual build below
        retrieval_types=[args.model],
        retrieval_params=[{"ncentroids": nlist, "nsubvector": 32}]))

    rng = np.random.default_rng(0)
    basis = (rng.normal(size=(16, args.d)) / 4).astype(np.float32)
    x = (rng.normal(size=(args.n, 16)).astype(np.float32) @ basis)

    t0 = time.perf_counter()
    batch = []
    for i in range(args.n):
        batch.append(Doc(key=f"k{i}", fields={"price": float(i % 1000)},
                         vectors={"vec": x[i]}))
        if len(batch) == 10_000:
            eng.add_or_update_docs(batch)
            batch = []
    if batch:
        eng.add_or_update_docs(batch)
    ingest_s = time.perf_counter() - t0
    print(f"ingest: {args.n} docs in {ingest_s:.1f}s "
          f"({args.n/ingest_s:,.0f} docs/s)", flush=True)

    t0 = time.perf_counter()
    eng.build_index()
    print(f"build_index: {time.perf_counter()-t0:.1f}s "
          f"status={eng.engine_status().index_status.name}", flush=True)

    queries = x[rng.choice(args.n, args.nq, replace=False)]
    filters = ([RangeFilter("price", 100.0, 500.0)]
               if args.filters else [])

    def make_req(qb):
        return Request(topn=args.topn,
                       vec_fields=[VectorQuery("vec", qb)],
                       range_filters=list(filters))

    def log(line):
        print(line, flush=True)

    rows = batch_sweep(eng, queries, make_req, log=log)
    if args.threads:
        thread_sweep(eng, queries, make_req, args.threads, log=log)
    print(json.dumps({"rows": rows, "ingest_docs_per_s":
                      round(args.n / ingest_s, 1)}))
    eng.close()


if __name__ == "__main__":
    main()
