"""Realtime semantics of the port: search during insert, update and
delete; NOT filters (the port's twin of tests/test_concurrent.py, plus
searcher threads beside every kind of mutation).

Searches run against published state: a mutation builds new tensors and
swaps them in (realtime/invert_index.py, RetrievalModel._publish), and a
search takes one snapshot of what it reads (RetrievalModel._read).  So a
search that runs beside an ingest batch, an update or a delete must not
raise, must not return a torn result (a -1 inside its first `total`
items, a doc that was deleted before the search began), and must keep
finding every doc that was flushed before the threads started.

Every thread is joined with a timeout and every mutation loop is bounded,
so a hang fails the test instead of stalling the run."""

import os
import sys
import threading
import time

import numpy as np
import pytest

from gamma_tpu_torch import (Doc, EngineConfig, FieldInfo, GammaEngine,
                             RangeFilter, Request, TableInfo, TermFilter,
                             VectorInfo, VectorQuery)
from gamma_tpu_torch.config import DataType

D = 32
N0 = 2000            # docs flushed before the threads start
SAFE = 1000          # docs [0, SAFE) are never updated or deleted
JOIN_S = 60.0        # a thread that has not ended by then hangs

# the models searched beside mutations: (retrieval type, params[, the
# vector field's store type])
MODELS = {
    "ivfpq_sq8_gather": ("IVFPQ", {"ncentroids": 16, "nsubvector": 8,
                                   "scan_mode": "gather"}),
    "ivfpq_dense": ("IVFPQ", {"ncentroids": 16, "nsubvector": 8}),
    "ivfflat": ("IVFFLAT", {"ncentroids": 16}),
    # the disk tier: the rerank reads host rows through the LRU while
    # the memmap grows and updates invalidate blocks
    "ivfpq_pq_disk": ("IVFPQ", {"ncentroids": 16, "nsubvector": 8,
                                "gather_payload": "pq"}, "RocksDB"),
    "binaryivf": ("BINARYIVF", {"ncentroids": 16}),
    # the graph is rebuilt (a new links tensor published with its
    # extent) at every 1.25x growth step while the searches walk it
    "hnsw": ("HNSW", {"nlinks": 16, "efSearch": 64}),
}
# the models with posting lists: updates re-place a vid and deletes
# compact the lists (HNSW keeps a re-added node's old links, as the
# JAX package does, and has no lists)
IVF_MODELS = sorted(k for k in MODELS if k != "hnsw")
# every list is probed (IVFFLAT takes nprobe from the request alone): a
# doc is then found wherever it was placed, so a miss is a fault
RP = {"nprobe": 16}


def make_engine(tmp_path, model="IVFPQ", params=None, indexing_size=1000,
                store_type="MemoryOnly"):
    eng = GammaEngine(EngineConfig(path=str(tmp_path)), device="cpu")
    eng.create_table(TableInfo(
        name="rt",
        fields=[FieldInfo("price", DataType.FLOAT, True),
                FieldInfo("tag", DataType.STRING, True)],
        vectors=[VectorInfo("vec", D, store_type=store_type)],
        indexing_size=indexing_size,
        retrieval_types=[model],
        retrieval_params=[params or {"ncentroids": 16, "nsubvector": 8}]))
    return eng


def docs_for(x, start=0):
    return [Doc(key=f"k{start+i}",
                fields={"price": float(start + i),
                        "tag": f"t{(start+i) % 3}"},
                vectors={"vec": x[i]}) for i in range(x.shape[0])]


def _vectors(seed, n):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


class Searchers:
    """Threads that search docs [0, SAFE) by their own vectors, four a
    request, and check every result; `dead` lists the docids whose
    delete has returned."""

    def __init__(self, eng, x, n_threads=3):
        self.eng, self.x = eng, x
        self.errors, self.dead = [], []
        self.searches = 0
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._run, args=(i,),
                                         daemon=True)
                        for i in range(n_threads)]

    def _check(self, qi, results, dead_before):
        for j, sr in enumerate(results):
            doc = qi + j
            if sr.result_code.name != "SUCCESS" or sr.total == 0:
                return f"bad result {sr.result_code} {sr.total}"
            items = sr.result_items
            if len(items) < min(sr.total, 5):
                return f"{len(items)} items of total {sr.total}"
            ids = [it.docid for it in items]
            if len(ids) != len(set(ids)):
                return f"a docid twice in one result: {ids}"
            if any(i < 0 for i in ids):
                return f"-1 inside the result of doc {doc}: {ids}"
            gone = dead_before.intersection(ids)
            if gone:
                return f"docs deleted before the search came back: {gone}"
            # self-retrieval of a doc flushed before the threads started
            # (a near-duplicate may win: then the distance is ~0)
            if ids[0] != doc and items[0].score > 1e-2:
                return f"lost doc {doc}: top={items[0]}"
        return None

    def _run(self, tid):
        qi = tid * 7
        try:
            while not self.stop.is_set():
                qi = (qi + 4) % (SAFE - 4)
                dead_before = set(self.dead)
                r = self.eng.search(Request(
                    topn=5, retrieval_params=RP,
                    vec_fields=[VectorQuery("vec", self.x[qi:qi + 4])]))
                err = self._check(qi, r.results, dead_before)
                if err:
                    self.errors.append(err)
                    return
                self.searches += 1
        except Exception as e:       # noqa: BLE001
            self.errors.append(repr(e))

    def __enter__(self):
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        for t in self.threads:
            t.join(JOIN_S)
        hung = [t.name for t in self.threads if t.is_alive()]
        assert not hung, f"searcher threads did not end: {hung}"
        return False


def _started(tmp_path, cfg, x, models=MODELS):
    """An engine holding x[:N0], trained, its background indexer on."""
    model, params, *store_type = models[cfg]
    eng = make_engine(tmp_path, model, params, store_type=(
        store_type[0] if store_type else "MemoryOnly"))
    eng.add_or_update_docs(docs_for(x[:N0]))
    eng.flush()
    assert eng.engine_status().index_status.name == "INDEXED"
    eng.start_background_indexer(interval_s=0.05)
    return eng


def _finish(eng, s):
    eng.flush()
    time.sleep(0.2)
    eng.stop_background_indexer()
    assert not s.errors, s.errors[:3]
    assert s.searches > 0, "no search completed beside the mutations"


def _top1(eng, q):
    r = eng.search(Request(topn=1, retrieval_params=RP,
                           vec_fields=[VectorQuery("vec", q)]))
    return r.results[0].result_items[0].docid


# ---- the three tests of tests/test_concurrent.py, on the port ----

def test_search_during_insert(tmp_path):
    x = _vectors(0, 6000)
    eng = make_engine(tmp_path)
    eng.add_or_update_docs(docs_for(x[:N0]))
    eng.flush()
    eng.start_background_indexer(interval_s=0.05)
    with Searchers(eng, x) as s:
        for start in range(N0, 6000, 500):
            eng.add_or_update_docs(docs_for(x[start:start + 500], start))
            time.sleep(0.05)
        eng.flush()
        time.sleep(0.3)
    _finish(eng, s)
    # everything ingested during the run is now searchable
    assert _top1(eng, x[5999]) == 5999
    eng.close()


def test_not_term_filter(tmp_path):
    x = _vectors(1, 1200)
    eng = make_engine(tmp_path)
    eng.add_or_update_docs(docs_for(x))
    eng.flush()
    req = Request(topn=20, vec_fields=[VectorQuery("vec", x[0])],
                  term_filters=[TermFilter("tag", ["t0"], is_union=2)],
                  fields=["tag"])
    items = eng.search(req).results[0].result_items
    assert items
    for it in items:
        assert it.attributes["tag"] != "t0"
    eng.close()


def test_update_refreshes_filter_mirror(tmp_path):
    x = _vectors(2, 1200)
    eng = make_engine(tmp_path)
    eng.add_or_update_docs(docs_for(x))
    eng.flush()
    # doc 10 starts at price=10; move it to 99999 and verify the filter
    # mirror sees the update after flush
    eng.add_or_update_doc(Doc(key="k10",
                              fields={"price": 99999.0, "tag": "t1"},
                              vectors={"vec": x[10]}))
    eng.flush()
    req = Request(topn=5, vec_fields=[VectorQuery("vec", x[10])],
                  range_filters=[RangeFilter("price", 99998.0, 100000.0)])
    r = eng.search(req)
    assert r.results[0].result_items
    assert r.results[0].result_items[0].docid == 10
    # and it no longer matches its old range
    req2 = Request(topn=5, vec_fields=[VectorQuery("vec", x[10])],
                   range_filters=[RangeFilter("price", 9.5, 10.5)])
    r2 = eng.search(req2)
    assert all(it.docid != 10 for it in r2.results[0].result_items)
    eng.close()


# ---- searches beside every kind of mutation, per model ----

@pytest.mark.parametrize("cfg", sorted(MODELS))
def test_searches_beside_background_ingest(tmp_path, cfg):
    """Inserts pumped by the background indexer (lists grow past their
    first capacity, the SQ8 sidecar and the mirror grow with them)."""
    x = _vectors(3, 5000)
    eng = _started(tmp_path, cfg, x)
    with Searchers(eng, x) as s:
        for start in range(N0, 5000, 250):
            eng.add_or_update_docs(docs_for(x[start:start + 250], start))
            time.sleep(0.04)
    _finish(eng, s)
    assert eng.engine_status().min_indexed_num == 5000
    assert _top1(eng, x[4999]) == 4999
    eng.close()


@pytest.mark.parametrize("cfg", IVF_MODELS)
def test_searches_beside_updates(tmp_path, cfg):
    """Updates of docs [SAFE, N0): the store row changes at once and the
    index tombstones and re-adds the vid when the pump drains the queue
    (RetrievalModel.update)."""
    x = _vectors(4, N0)
    x2 = _vectors(5, N0)
    eng = _started(tmp_path, cfg, x)
    with Searchers(eng, x) as s:
        for i in range(SAFE, SAFE + 400):
            assert eng.add_or_update_doc(Doc(
                key=f"k{i}", fields={"price": float(i), "tag": "t0"},
                vectors={"vec": x2[i]})) == 0
            if i % 20 == 0:
                time.sleep(0.02)
    _finish(eng, s)
    # the updated docs are found at their new vectors, and only there
    for i in (SAFE, SAFE + 199, SAFE + 399):
        assert _top1(eng, x2[i]) == i
        assert _top1(eng, x[i]) != i
    assert eng.engine_status().doc_count == N0
    eng.close()


@pytest.mark.parametrize("cfg", IVF_MODELS)
def test_searches_beside_deletes(tmp_path, cfg):
    """Deletes of docs [SAFE, N0), half the corpus: past 30% tombstones
    the pump compacts the lists (slots move under the searches).  A doc
    whose delete returned before a search began is never in its result."""
    x = _vectors(6, N0)
    eng = _started(tmp_path, cfg, x)
    with Searchers(eng, x) as s:
        for i in range(SAFE, N0):
            assert eng.delete(f"k{i}") == 0
            s.dead.append(i)
            if i % 50 == 0:
                time.sleep(0.02)
    _finish(eng, s)
    model = eng.vm.index_for("vec")
    assert eng.engine_status().doc_count == SAFE
    st = model.state
    assert int(st.lens.sum()) < N0                  # the lists were compacted
    pos = np.arange(st.cap)[None, :]
    assert int(((st.docids.numpy() >= 0)
                & (pos < st.lens.numpy()[:, None])).sum()) == SAFE
    r = eng.search(Request(topn=10, retrieval_params=RP,
                           vec_fields=[VectorQuery("vec",
                                                   x[SAFE:SAFE + 50])]))
    assert all(it.docid < SAFE for sr in r.results
               for it in sr.result_items)
    eng.close()


# the pump's models: one with posting lists, and the graph
PUMP_MODELS = {"ivfpq_pq_gather": ("IVFPQ", {"ncentroids": 16,
                                             "nsubvector": 8,
                                             "scan_mode": "gather",
                                             "gather_payload": "pq"}),
               "hnsw": MODELS["hnsw"]}


@pytest.mark.parametrize("cfg", sorted(PUMP_MODELS))
def test_two_flushes_post_each_vid_once(tmp_path, monkeypatch, cfg):
    """Two callers of flush() at once (the background indexer's and a
    caller's), the index's add slowed so that the second pump starts
    while the first is adding: every vid is posted once, the lists hold
    one slot a vid, and no search answers a doc twice."""
    x = _vectors(8, N0 + 250)
    model_name, params = PUMP_MODELS[cfg]
    eng = make_engine(tmp_path, model_name, params)
    eng.add_or_update_docs(docs_for(x[:N0]))
    eng.flush()
    model = eng.vm.index_for("vec")
    posted, real_add = [], model.add

    def slow_add(rows, vids, docids):
        posted.extend(int(v) for v in vids)
        time.sleep(0.2)
        real_add(rows, vids, docids)

    monkeypatch.setattr(model, "add", slow_add)
    eng.add_or_update_docs(docs_for(x[N0:], N0))
    flushes = [threading.Thread(target=eng.flush, daemon=True)
               for _ in range(2)]
    for t in flushes:
        t.start()
    for t in flushes:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in flushes)
    assert sorted(posted) == list(range(N0, N0 + 250))
    assert model.indexed_count == N0 + 250
    if cfg != "hnsw":
        st = model.state
        pos = np.arange(st.cap)[None, :]
        assert int(((st.docids.numpy() >= 0)
                    & (pos < st.lens.numpy()[:, None])).sum()) == N0 + 250
    r = eng.search(Request(topn=10, retrieval_params=RP,
                           vec_fields=[VectorQuery("vec",
                                                   x[N0 - 25:N0 + 25])]))
    for i, sr in enumerate(r.results):
        ids = [it.docid for it in sr.result_items]
        assert ids[0] == N0 - 25 + i and len(ids) == len(set(ids)), ids
    eng.close()


def test_background_indexer_logs_a_failed_flush(tmp_path, monkeypatch,
                                                caplog):
    """A pump fault in the background indexer is logged, and the loop
    goes on flushing."""
    import logging
    x = _vectors(9, N0)
    eng = make_engine(tmp_path)
    eng.add_or_update_docs(docs_for(x[:N0]))
    eng.flush()
    calls = []
    real_pump = eng.vm.add_rt_vecs_to_index

    def failing_pump():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("pump fault")
        return real_pump()

    monkeypatch.setattr(eng.vm, "add_rt_vecs_to_index", failing_pump)
    with caplog.at_level(logging.ERROR, logger=eng.log.name):
        eng.start_background_indexer(interval_s=0.02)
        deadline = time.monotonic() + JOIN_S
        while len(calls) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        eng.stop_background_indexer()
    assert len(calls) >= 3
    assert any("background flush failed" in r.getMessage()
               and r.exc_info and "pump fault" in str(r.exc_info[1])
               for r in caplog.records)
    eng.close()


@pytest.mark.parametrize("brute", [False, True])
def test_filtered_search_beside_a_growing_validity(tmp_path, brute):
    """A flush that grows the validity publishes it before it counts its
    device rows.  A filtered search between the two steps (here: the
    validity one pad longer, the count not yet raised) composes its
    penalty from the validity it read, and answers."""
    import torch
    from gamma_tpu_torch.engine import ROW_PAD
    from gamma_tpu_torch.ops.distances import BIG
    x = _vectors(10, 1200)
    eng = make_engine(tmp_path)
    eng.add_or_update_docs(docs_for(x))
    eng.flush()
    eng._validity = torch.nn.functional.pad(eng._validity, (0, ROW_PAD),
                                            value=BIG)
    r = eng.search(Request(topn=5, retrieval_params=RP,
                           brute_force_search=brute,
                           vec_fields=[VectorQuery("vec", x[:4])],
                           range_filters=[RangeFilter("price", 0.0, 600.0)]))
    assert [sr.result_items[0].docid for sr in r.results] == [0, 1, 2, 3]
    eng.close()


def test_publish_and_read_never_tear():
    """RetrievalModel._publish swaps several attributes as one step and
    _read takes them as one snapshot: with more threads than cores and
    the interpreter switching threads every microsecond, no reader ever
    sees the halves of two publishes (bare attribute reads would)."""
    from gamma_tpu_torch.index import create_model
    from gamma_tpu_torch.vector.raw_store import RawVectorStore

    model = create_model("FLAT", RawVectorStore("vec", D, device="cpu"), {})
    model._publish(left=0, right=0)
    stop, torn = threading.Event(), []

    def reader():
        while not stop.is_set():
            left, right = model._read("left", "right")
            if left != right:
                torn.append((left, right))
                return

    readers = [threading.Thread(target=reader, daemon=True)
               for _ in range(min(16, 2 * (os.cpu_count() or 2)))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in readers:
            t.start()
        deadline = time.monotonic() + 2.0
        n = 0
        while time.monotonic() < deadline and not torn:
            n += 1
            model._publish(left=n, right=n)
        stop.set()
        for t in readers:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in readers)
    assert n > 100 and not torn, torn[:3]


# ---- sharded searches beside background ingest ----

# the scan modes of the sharded search: SQ8 sidecar, dense mirror, PQ
SHARDED_MODELS = {
    "ivfpq_sq8_gather": MODELS["ivfpq_sq8_gather"],
    "ivfpq_dense": MODELS["ivfpq_dense"],
    "ivfpq_pq_gather": ("IVFPQ", {"ncentroids": 16, "nsubvector": 8,
                                  "scan_mode": "gather",
                                  "gather_payload": "pq"}),
}


# every searcher fails on a docid twice in one result (sharded: a row in
# both the snapshot and the realtime tail)
ShardedSearchers = Searchers


@pytest.mark.parametrize("cfg", sorted(SHARDED_MODELS))
def test_sharded_searches_beside_background_ingest(tmp_path, cfg):
    """Sharded searches over a 2 x 4 mesh of the CPU beside inserts the
    background indexer pumps: the first search builds the snapshot while
    rows are indexed, the snapshot serves the docs indexed before it and
    the live index the rest.  No docid comes back twice in a result,
    every doc flushed before the threads started is found, and so is
    the last doc ingested."""
    import torch
    x = _vectors(7, 5000)
    eng = _started(tmp_path, cfg, x, SHARDED_MODELS)
    eng.enable_sharded_search(n_list_shards=4, n_query_shards=2,
                              devices=[torch.device("cpu")] * 8)
    with ShardedSearchers(eng, x) as s:
        for start in range(N0, 5000, 250):
            eng.add_or_update_docs(docs_for(x[start:start + 250], start))
            time.sleep(0.04)
    _finish(eng, s)
    mode = {"ivfpq_dense": "dense", "ivfpq_sq8_gather": "sq"}.get(cfg,
                                                                  "index")
    assert eng._sharded[mode] is not None
    assert eng.engine_status().min_indexed_num == 5000
    assert _top1(eng, x[4999]) == 4999
    r = eng.search(Request(topn=10, retrieval_params=RP,
                           vec_fields=[VectorQuery("vec", x[N0:N0 + 50])]))
    for sr in r.results:
        ids = [it.docid for it in sr.result_items]
        assert len(ids) == len(set(ids)), ids
    eng.close()
