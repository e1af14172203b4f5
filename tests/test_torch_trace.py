"""The port's per-request spans (utils/perf.py's PerfTool, on with
online_log_level="debug") on small IVFPQ engines, dense and gather over
the PQ payload: one request's spans nest under `engine.search` in order,
the checkpoints keep their format, the packing's object count, the
batcher's spans and a coalesced batch's shared model spans, collections
under the span they interrupt, nothing at all with tracing off; and on
the card (`-m cuda`), positive device time for every model phase."""

import gc
import re
import threading

import numpy as np
import pytest

from gamma_tpu_torch import (DataType, Doc, EngineConfig, FieldInfo,
                             GammaEngine, Request, TableInfo, VectorInfo,
                             VectorQuery)
from gamma_tpu_torch.utils.perf import PerfTool

N, D, TOPN, NQ = 2000, 32, 5, 3
MODES = {
    "dense": {"ncentroids": 16, "nsubvector": 8, "nprobe": 4},
    "gather": {"ncentroids": 16, "nsubvector": 8, "nprobe": 4,
               "scan_mode": "gather", "gather_payload": "pq"},
}
PHASES = {"dense": ["dense.score", "dense.select", "rerank"],
          "gather": ["gather.coarse", "gather.adc", "gather.select",
                     "rerank"]}
ROOT_CHILDREN = ["engine.admit", "engine.filter", "engine.scan:emb",
                 "engine.merge", "engine.pack"]
CHECKPOINTS = re.compile(r"filter:\d+\.\d{3}ms scan:emb:\d+\.\d{3}ms "
                         r"merge:\d+\.\d{3}ms pack:\d+\.\d{3}ms "
                         r"total:\d+\.\d{3}ms")


def _corpus():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(16, D)).astype(np.float32)
    return (centers[rng.integers(0, 16, N)]
            + 0.1 * rng.normal(size=(N, D))).astype(np.float32)


def _engine(path, mode, device="cpu"):
    x = _corpus()
    eng = GammaEngine(EngineConfig(path=str(path)), device=device)
    eng.create_table(TableInfo(
        name="t", fields=[FieldInfo("p", DataType.FLOAT)],
        vectors=[VectorInfo("emb", D)], indexing_size=1000,
        retrieval_types=["IVFPQ"], retrieval_params=[MODES[mode]]))
    assert not any(eng.add_or_update_docs(
        [Doc(key=f"k{i}", fields={"p": float(i)}, vectors={"emb": x[i]})
         for i in range(N)]))
    eng.flush()
    return eng, x


@pytest.fixture(scope="module", params=sorted(MODES))
def engine(request, tmp_path_factory):
    eng, x = _engine(tmp_path_factory.mktemp(request.param), request.param)
    yield request.param, eng, x
    eng.close()


def _search(eng, x, rows=range(NQ), debug=True, fields=None):
    return eng.search(Request(
        vec_fields=[VectorQuery("emb", x[list(rows)])], topn=TOPN,
        fields=fields or [], online_log_level="debug" if debug else ""))


def _record(resp):
    (rec,) = resp.trace
    return rec


def _named(rec, name):
    return [s for s in rec.spans if s.name == name]


def _children(rec, parent):
    return [s for s in rec.spans
            if s.parent_in(rec.request_id) == parent.span_id]


def test_spans_share_the_request_and_nest_under_the_root(engine):
    mode, eng, x = engine
    rec = _record(_search(eng, x))
    by_id = {s.span_id: s for s in rec.spans}
    (root,) = [s for s in rec.spans if s.parent_in(rec.request_id) == 0]
    assert root.name == "engine.search" and rec.spans[0] is root
    for s in rec.spans:
        assert rec.request_id in s.request_ids
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        p, hops = s, 0
        while p is not root:
            p = by_id[p.parent_in(rec.request_id)]
            hops += 1
            assert hops < 10
    assert len({s.span_id for s in rec.spans}) == len(rec.spans)


def test_root_children_lie_inside_it_in_order(engine):
    mode, eng, x = engine
    rec = _record(_search(eng, x))
    root = _named(rec, "engine.search")[0]
    kids = sorted(_children(rec, root), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ROOT_CHILDREN
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    pack = kids[-1]
    assert [s.name for s in sorted(_children(rec, pack),
                                   key=lambda s: s.start_ns)] == [
        "engine.pack.flatten", "engine.pack.lookup", "engine.pack.items"]


def test_checkpoints_keep_their_format(engine):
    mode, eng, x = engine
    assert CHECKPOINTS.fullmatch(_search(eng, x).online_log_message)


@pytest.mark.parametrize("fields", [[], ["p"]])
def test_pack_objects_counts_what_the_packing_made(engine, fields):
    """Read from the collector's own count: an item and its attributes
    dict a hit (the fields' dict takes the default's place), a
    SearchResult and its list a query; twice the hits, twice the count
    they add.  Free lists hold at most 80 objects of a type, whence the
    slack."""
    mode, eng, x = engine
    made = {}
    for topn in (10, 20):
        resp = eng.search(Request(
            vec_fields=[VectorQuery("emb", x[:100])], topn=topn,
            fields=fields, online_log_level="debug"))
        assert sum(len(sr.result_items) for sr in resp.results) \
            == 100 * topn
        counters = _record(resp).counters
        assert list(counters) == ["pack.objects", "gc.frozen"]
        made[topn] = counters["pack.objects"]
        assert made[topn] == pytest.approx(2 * 100 * topn + 2 * 100,
                                           abs=200)
    assert made[20] - made[10] == pytest.approx(2 * 100 * 10, abs=200)


def test_model_phases_nest_under_the_scan(engine):
    mode, eng, x = engine
    rec = _record(_search(eng, x))
    scan = _named(rec, "engine.scan:emb")[0]
    kids = {s.name: s for s in _children(rec, scan)}
    assert {"batcher.wait", "batcher.run", "batcher.handback",
            "model.upload", "model.search", "model.copy"} <= set(kids)
    run = kids["batcher.run"]
    assert run.attrs == {"rows": NQ, "group": 1}
    assert run.thread_id != scan.thread_id
    for name in ("model.upload", "model.search", "model.copy"):
        s = kids[name]
        assert s.thread_id == run.thread_id
        assert run.start_ns <= s.start_ns <= s.end_ns <= run.end_ns
    assert (kids["batcher.wait"].end_ns <= run.start_ns
            <= run.end_ns <= kids["batcher.handback"].start_ns)
    phases = _children(rec, kids["model.search"])
    assert sorted({s.name for s in phases}) == sorted(PHASES[mode])
    assert rec.device_ms == {}          # no events off the card


def test_a_coalesced_batch_shares_its_model_spans(tmp_path):
    eng, x = _engine(tmp_path, "dense")
    _search(eng, x)
    eng._batcher.pause()
    resps = {}

    def worker(i):
        resps[i] = _search(eng, x, rows=[i])

    before = eng._batcher.batches_run
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for _ in range(2000):
        with eng._batcher._cv:
            if len(eng._batcher._pending) == 4:
                break
        threading.Event().wait(0.005)
    eng._batcher.resume()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert eng._batcher.batches_run - before == 1
    recs = [_record(resps[i]) for i in range(4)]
    ids = {r.request_id for r in recs}
    assert len(ids) == 4
    shared = {_named(r, "model.search")[0].span_id for r in recs}
    assert len(shared) == 1
    for r in recs:
        scan = _named(r, "engine.scan:emb")[0]
        assert scan.request_ids == (r.request_id,)
        for name in ("batcher.wait", "batcher.run", "batcher.handback"):
            (s,) = _named(r, name)
            assert s.request_ids == (r.request_id,)
            assert s.parent_in(r.request_id) == scan.span_id
        assert _named(r, "batcher.run")[0].attrs == {"rows": 4, "group": 4}
        model = _named(r, "model.search")[0]
        assert set(model.request_ids) == ids
        assert model.parent_in(r.request_id) == scan.span_id
        for s in _children(r, model):
            assert set(s.request_ids) == ids
    eng.close()


def test_a_collection_is_parented_to_the_span_it_interrupts(engine,
                                                            monkeypatch):
    mode, eng, x = engine
    merge = eng._merge_fields

    def collecting(*a, **kw):
        gc.collect(2)
        return merge(*a, **kw)

    monkeypatch.setattr(eng, "_merge_fields", collecting)
    rec = _record(_search(eng, x))
    gcs = _named(rec, "gc.gen2")
    assert gcs and all(s.attrs["collected"] >= 0 for s in gcs)
    parent = _named(rec, "engine.merge")[0]
    forced = [s for s in gcs if s.parent_in(rec.request_id)
              == parent.span_id]
    assert len(forced) == 1
    assert parent.start_ns <= forced[0].start_ns <= forced[0].end_ns \
        <= parent.end_ns


def test_a_collection_in_the_batcher_thread_joins_the_model_span(
        engine, monkeypatch):
    mode, eng, x = engine
    model = eng.vm.index_for("emb")
    search = model.search

    def collecting(*a, **kw):
        gc.collect(2)
        return search(*a, **kw)

    monkeypatch.setattr(model, "search", collecting)
    rec = _record(_search(eng, x))
    (parent,) = _named(rec, "model.search")
    forced = [s for s in _named(rec, "gc.gen2")
              if s.parent_in(rec.request_id) == parent.span_id]
    assert len(forced) == 1 and forced[0].thread_id == parent.thread_id
    assert parent.thread_id != _named(rec, "engine.search")[0].thread_id


def test_a_collection_is_parented_to_the_innermost_open_span():
    tool = PerfTool(True)
    with tool.span("outer"):
        with tool.span("inner") as inner:
            gc.collect(1)
    (rec,) = tool.records()
    (g,) = _named(rec, "gc.gen1")
    assert g.parent_in(rec.request_id) == inner.span_id


def test_tracing_off_leaves_nothing(engine, monkeypatch):
    mode, eng, x = engine
    hooks = len(gc.callbacks)
    seen = []
    merge = eng._merge_fields

    def counting(*a, **kw):
        seen.append(len(gc.callbacks))
        return merge(*a, **kw)

    monkeypatch.setattr(eng, "_merge_fields", counting)
    resp = _search(eng, x, debug=False)
    assert resp.trace == () and resp.online_log_message == ""
    assert seen == [hooks] and len(gc.callbacks) == hooks
    resp = _search(eng, x)              # on: the hook only while open
    assert seen[-1] == hooks + 1 and len(gc.callbacks) == hooks


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_model_phase_has_device_time(tmp_path, mode):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    eng, x = _engine(tmp_path, mode, device="cuda")
    _search(eng, x)
    rec = _record(_search(eng, x))
    want = ["model.upload", "model.search"] + PHASES[mode]
    for name in want:
        assert rec.device_ms.get(name, 0.0) > 0.0, (name, rec.device_ms)
    assert "model.copy" not in rec.device_ms
    eng.close()


def test_the_router_concatenates_its_parts_records(engine, monkeypatch):
    from gamma_tpu_torch.cluster.router import GammaRouter
    mode, eng, x = engine
    router = GammaRouter(["part-0", "part-1"])
    monkeypatch.setattr(router, "_one_partition_search",
                        lambda pi, request: eng.search(request))
    resp = router.search(Request(
        vec_fields=[VectorQuery("emb", x[:NQ])], topn=TOPN,
        online_log_level="debug"))
    assert len(resp.trace) == 2
    assert len({r.request_id for r in resp.trace}) == 2
    assert resp.online_log_message.count("pack:") == 2
    router.close()
