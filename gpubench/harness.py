"""One run of a cell: set-up, the measured window, the check, the metrics.

Set-up makes the corpus, query pool and doc keys from the seed on the
device, builds the engine the configuration describes, ingests every doc
through `GammaEngine.add_or_update_docs` in INGEST_BATCH calls (the call
that reaches `indexing_size` trains the index) and one `flush()`, and
warms the cell's one request shape.  The window sends
the traffic through `GammaEngine.search` from this one thread, a closed
loop, until `seconds` have passed.  Once it has closed, the peak of
device memory is read, the engine is freed, and every answer is held
against the plain reference (check.py).

With `traced`, the program's PerfTool checkpoints are on, and a second
window of `seconds` follows the first: the first, untraced, gives the
host-clock metrics (the profiler's own objects would lengthen every
garbage collection in it); the second runs under torch.profiler with the
engine's and the model's search timed, and gives the device's
(trace.py).  The interpreter's garbage collections are timed in both, so
the notes show what the profiler adds to them.  Both windows' answers
are checked.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gpubench import check, corpus, trace
from gpubench import traffic as tr
from gpubench.reference.exact import Exact
from gpubench.spec import Cell

FIELD = "emb"
INGEST_BATCH = 65_536
WARMUP = 2


@dataclasses.dataclass
class Record:
    """What a run measured; each metric's reader takes its number here."""
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    params: Dict[str, Any]
    kind: str = ""                      # the device's name
    scan_mode: str = ""                 # the model's resolved scan mode
    setup_s: float = 0.0
    train_s: float = 0.0                # the first add_or_update_docs
    ingest_docs: int = 0                # docs after training ...
    ingest_s: float = 0.0               # ... their adds and the flush
    # the window (with `traced`, the first, untraced one):
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    perf: List[list] = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    answered: int = 0                   # queries with an answer
    recall: Optional[float] = None
    trace: Optional[Dict[str, Any]] = None   # the traced window's


@dataclasses.dataclass
class Window:
    """What one measured window sent and got back."""
    rows: List[np.ndarray] = dataclasses.field(default_factory=list)
    keys: List[np.ndarray] = dataclasses.field(default_factory=list)
    scores: List[np.ndarray] = dataclasses.field(default_factory=list)
    spans: List[tuple] = dataclasses.field(default_factory=list)
    perf: List[list] = dataclasses.field(default_factory=list)
    failed: int = 0
    seconds: float = 0.0
    gc: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def attempted(self) -> int:
        return sum(r.shape[0] for r in self.rows)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _engine(cfg, device, path, control: bool):
    from gamma_tpu_torch import (EngineConfig, GammaEngine, TableInfo,
                                 VectorInfo)
    store = cfg["store"]
    param = dict(store["store_param"])
    if control:
        param.update(cfg["control"]["store_param"])
    eng = GammaEngine(EngineConfig(path=path, **cfg.get("engine", {})),
                      device=device)
    eng.create_table(TableInfo(
        name="bench", fields=[],
        vectors=[VectorInfo(FIELD, int(cfg["corpus"]["d"]),
                            store_type=store["store_type"],
                            store_param=param)],
        indexing_size=int(cfg["indexing_size"]),
        retrieval_types=[cfg["model"]],
        retrieval_params=[dict(cfg["retrieval_params"])]))
    return eng


def _ingest(eng, corpus_h: np.ndarray, keys: np.ndarray, cfg, device,
            rec: Record) -> None:
    """Every doc in INGEST_BATCH calls, each batch's Docs made just
    before its call: the calls up to `indexing_size` docs (the last of
    them trains the index), then the rest and one flush."""
    from gamma_tpu_torch import Doc

    def add(start, stop):
        codes = []
        for s in range(start, stop, INGEST_BATCH):
            e = min(stop, s + INGEST_BATCH)
            codes += eng.add_or_update_docs(
                [Doc(key=k, vectors={FIELD: corpus_h[s + i]})
                 for i, k in enumerate(keys[s:e].tolist())])
        return codes

    n = keys.shape[0]
    first = min(n, int(cfg["indexing_size"]))
    t = time.perf_counter()
    codes = add(0, first)
    _sync(device)
    rec.train_s = time.perf_counter() - t
    t = time.perf_counter()
    codes += add(first, n)
    eng.flush()
    _sync(device)
    rec.ingest_s = time.perf_counter() - t
    rec.ingest_docs = n - first
    st = eng.engine_status()
    if any(codes) or st.index_status.name != "INDEXED" \
            or st.min_indexed_num != n:
        raise RuntimeError(f"ingest left the engine at {st} "
                           f"({sum(1 for c in codes if c)} docs refused)")


def _unpack(resp, batch: int, topn: int):
    """(keys, scores) [batch, topn] of a response, -1 and NaN where a
    query has no hit there; and how many queries got no answer."""
    from gamma_tpu_torch.api.response import SearchResultCode
    res = resp.results
    ok = SearchResultCode.SUCCESS
    if len(res) == batch and all(sr.result_code == ok
                                 and len(sr.result_items) == topn
                                 for sr in res):
        items = [it for sr in res for it in sr.result_items]
        try:
            return (np.array([it.key for it in items], np.float64).reshape(
                        batch, topn),
                    np.array([it.score for it in items],
                             np.float64).reshape(batch, topn), 0)
        except (TypeError, ValueError):
            pass
    keys = np.full((batch, topn), -1.0)
    scores = np.full((batch, topn), np.nan)
    missing = 0
    for b in range(batch):
        if b >= len(res) or res[b].result_code != ok:
            missing += 1
            continue
        for j, it in enumerate(res[b].result_items[:topn]):
            try:
                keys[b, j], scores[b, j] = float(it.key), float(it.score)
            except (TypeError, ValueError):
                pass
    return keys, scores, missing


def _request(queries_h, i: int, rec: Record, perf: bool):
    """Request i of the traffic and its pool rows."""
    from gamma_tpu_torch import Request, VectorQuery
    r = tr.rows(i, int(rec.traffic["batch"]), queries_h.shape[0])
    return r, Request(vec_fields=[VectorQuery(FIELD, queries_h[r])],
                      topn=int(rec.traffic["topn"]),
                      retrieval_params=rec.params,
                      online_log_level="debug" if perf else "")


def _window(eng, queries_h, rec: Record, seconds: float, perf: bool,
            spanned: bool = False, first: int = 0) -> Window:
    """Requests first, first + 1, ... until `seconds` have passed; with
    `perf` the program's checkpoints are kept, with `spanned` each
    search is also a profiler span."""
    batch, topn = int(rec.traffic["batch"]), int(rec.traffic["topn"])
    span = (torch.profiler.record_function if spanned
            else lambda _: contextlib.nullcontext())
    w = Window()
    before = gc.get_stats()
    w.gc["tracked_at_start"] = len(gc.get_objects())
    t_start = t_end = time.perf_counter()
    deadline = t_start + seconds
    i = first
    while i == first or t_end < deadline:
        r, req = _request(queries_h, i, rec, perf)
        t0 = time.perf_counter()
        with span(trace.ENGINE_SPAN):
            resp = eng.search(req)
        t_end = time.perf_counter()
        w.spans.append((t0, t_end))
        k, s, missing = _unpack(resp, batch, topn)
        w.failed += missing
        w.rows.append(r)
        w.keys.append(k)
        w.scores.append(s)
        if perf:
            w.perf.append(trace.parse_perf(resp.online_log_message))
        i += 1
    w.seconds = t_end - t_start
    for g, (a, b) in enumerate(zip(before, gc.get_stats())):
        w.gc[f"gen{g}"] = b["collections"] - a["collections"]
    return w


def _warm(eng, queries_h, rec: Record, perf: bool) -> None:
    for i in range(WARMUP):
        eng.search(_request(queries_h, i, rec, perf)[1])


@contextlib.contextmanager
def _gc_spans(spans: list):
    """Time the interpreter's collections of generations 1 and 2."""
    def cb(phase, info):
        if phase == "start":
            cb.t = time.perf_counter()
        elif info["generation"] >= 1:
            spans.append((cb.t, time.perf_counter(), info["generation"]))

    gc.callbacks.append(cb)
    try:
        yield
    finally:
        gc.callbacks.remove(cb)


def _gc_seconds(spans) -> Dict[str, float]:
    """Seconds of collections by generation: the share of a window the
    interpreter's pauses take, with and without the profiler."""
    out: Dict[str, float] = {}
    for a, b, g in spans:
        out[f"gen{g}"] = out.get(f"gen{g}", 0.0) + (b - a)
    return out


@contextlib.contextmanager
def _model_span(model, spans: list):
    """Time the model's search (on this instance only) into `spans`."""
    orig = model.search

    def spanned(*a, **kw):
        t = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            spans.append((t, time.perf_counter()))

    model.search = spanned
    try:
        yield
    finally:
        del model.search


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device, t0: float, control: bool = False) -> Dict[str, Any]:
    """One run; `t0` is the perf_counter at which set-up began."""
    from gamma_tpu_torch.config import SearchParams
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg, traf = cell.config, cell.traffic
    tr.check(traf)
    rec = Record(cfg, traf, tr.retrieval_params(cfg, traf))
    rec.kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    data = corpus.make(cfg, seed, device)
    corpus_h = data.corpus.cpu().numpy()
    queries_h = data.queries.cpu().numpy()
    keys = data.keys.cpu().numpy()
    del data
    path = tempfile.mkdtemp(prefix="gpubench-")
    try:
        eng = _engine(cfg, device, path, control)
        _ingest(eng, corpus_h, keys, cfg, device, rec)
        gc.collect()
        model = eng.vm.index_for(FIELD)
        rec.scan_mode = model.scan_mode(SearchParams.from_dict(rec.params))
        _warm(eng, queries_h, rec, traced)
        _sync(device)
        rec.setup_s = time.perf_counter() - t0
        host_gc: list = []
        with (_gc_spans(host_gc) if traced else contextlib.nullcontext()):
            win = _window(eng, queries_h, rec, seconds, traced)
        windows = [win]
        rec.latencies_s = [b - a for a, b in win.spans]
        rec.perf, rec.window_s = win.perf, win.seconds
        rec.answered = win.attempted - win.failed
        if traced:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            model_spans, gc_spans = [], []
            with _model_span(model, model_spans), _gc_spans(gc_spans), \
                    profile(activities=acts) as prof:
                tw = _window(eng, queries_h, rec, seconds, True,
                             spanned=True, first=len(win.spans))
            windows.append(tw)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if traced:
            rec.trace = trace.reduce(prof.events(), tw.spans, model_spans,
                                     gc_spans, tw.perf)
            del prof
        eng.close()
        del eng, model
    finally:
        shutil.rmtree(path, ignore_errors=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    row_of_key = np.empty_like(keys)
    row_of_key[keys - corpus.KEY_BASE] = np.arange(keys.size)
    attempted = sum(w.attempted for w in windows)
    failed = sum(w.failed for w in windows)
    numbers, rec.recall = check.compare(
        np.concatenate([r for w in windows for r in w.rows]),
        np.concatenate([k for w in windows for k in w.keys]),
        np.concatenate([x for w in windows for x in w.scores]), row_of_key,
        Exact(corpus_h, queries_h, device), int(traf["topn"]), cell.limits)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = m.read(rec)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": rec.kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {
        "correct": failed == 0 and check.passed(numbers),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": dev}
    if traced and rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    out["notes"] = {"requests": len(win.spans), "window_s": win.seconds,
                    "train_s": rec.train_s, "ingest_s": rec.ingest_s,
                    "scan_mode": rec.scan_mode, "gc_in_window": win.gc}
    if traced:
        out["notes"].update(gc_s_in_window=_gc_seconds(host_gc),
                            trace_requests=len(tw.spans), gc_in_trace=tw.gc,
                            gc_s_in_trace=_gc_seconds(gc_spans))
    out["compared"] = numbers
    return out
