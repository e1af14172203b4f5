"""The engine's heap out of the cyclic collector's reach
(gamma_tpu_torch/utils/heap.py): `build_index` and `load` settle the
heap (one collection, then `gc.freeze()`), traced searches count what
was frozen (`gc.frozen`), `close` releases the engine and the last
engine closed unfreezes the heap, so a closed engine is reclaimed even
through a cycle; a search reads the same over a frozen heap.

Every test starts and ends with the worker's heap unfrozen and no
engine of an earlier test counted, so later tests see the default
collector."""

import gc
import sys
import threading
import weakref

import numpy as np
import pytest

from gamma_tpu_torch import (DataType, Doc, EngineConfig, FieldInfo,
                             GammaEngine, Request, TableInfo, VectorInfo,
                             VectorQuery)
from gamma_tpu_torch.utils import heap

N, D, TOPN, NQ = 1200, 16, 5, 8


@pytest.fixture(autouse=True)
def unfrozen(monkeypatch):
    gc.unfreeze()
    monkeypatch.setattr(heap, "_owners", {})
    monkeypatch.setattr(heap, "_frozen", 0)
    yield
    gc.unfreeze()


def _corpus():
    rng = np.random.default_rng(5)
    return rng.normal(size=(N, D)).astype(np.float32)


def _engine(path, n=N, indexing_size=1000):
    x = _corpus()
    eng = GammaEngine(EngineConfig(path=str(path)), device="cpu")
    eng.create_table(TableInfo(
        name="t", fields=[FieldInfo("p", DataType.FLOAT)],
        vectors=[VectorInfo("emb", D)], indexing_size=indexing_size,
        retrieval_types=["IVFPQ"],
        retrieval_params=[{"ncentroids": 8, "nsubvector": 4,
                           "nprobe": 8}]))
    assert not any(eng.add_or_update_docs(
        [Doc(key=f"k{i}", fields={"p": float(i)}, vectors={"emb": x[i]})
         for i in range(n)]))
    eng.flush()
    return eng, x


def _search(eng, x):
    return eng.search(Request(
        vec_fields=[VectorQuery("emb", x[:NQ])], topn=TOPN,
        online_log_level="debug"))


def _frozen_counter(resp):
    (rec,) = resp.trace
    return rec.counters["gc.frozen"]


def _answers(resp):
    return [[(it.key, it.score) for it in sr.result_items]
            for sr in resp.results]


def test_build_index_freezes_the_heap_and_searches_count_it(tmp_path):
    eng, x = _engine(tmp_path)        # past indexing_size: trained
    assert eng.engine_status().index_status.name == "INDEXED"
    # the imported modules alone are many thousands of objects
    assert heap.frozen() > 10_000 and gc.get_freeze_count() > 10_000
    assert _frozen_counter(_search(eng, x)) == heap.frozen()
    eng.close()
    assert gc.get_freeze_count() == 0 and heap.frozen() == 0


def test_nothing_is_frozen_before_a_build(tmp_path):
    eng, x = _engine(tmp_path, n=500)  # under indexing_size: untrained
    assert eng.engine_status().index_status.name == "UNINDEXED"
    assert _frozen_counter(_search(eng, x)) == 0
    assert gc.get_freeze_count() == 0
    eng.close()


def test_the_last_engine_closed_unfreezes(tmp_path):
    a, _ = _engine(tmp_path / "a")
    b, _ = _engine(tmp_path / "b")
    a.build_index()                   # a second settle of one engine
    a.close()
    assert gc.get_freeze_count() > 0 and heap.frozen() > 0
    b.close()
    assert gc.get_freeze_count() == 0 and heap.frozen() == 0


def test_a_closed_engine_is_reclaimed_through_a_cycle(tmp_path):
    eng, x = _engine(tmp_path)
    _search(eng, x)                   # the batcher's thread holds it too
    eng.itself = eng                  # a cycle only the collector frees
    ref = weakref.ref(eng)
    eng.close()
    del eng
    gc.collect()
    assert ref() is None


def test_a_search_reads_the_same_over_a_frozen_heap(tmp_path):
    eng, x = _engine(tmp_path)
    assert gc.get_freeze_count() > 0
    settled = _answers(_search(eng, x))
    gc.unfreeze()
    assert settled == _answers(_search(eng, x))
    assert sum(map(len, settled)) == NQ * TOPN
    eng.close()


def test_load_settles_as_build_index_does(tmp_path):
    eng, x = _engine(tmp_path)
    want = _answers(_search(eng, x))
    assert eng.dump() == 0
    eng.close()
    assert gc.get_freeze_count() == 0
    back = GammaEngine(EngineConfig(path=str(tmp_path)), device="cpu")
    assert back.load() == 0
    assert back.engine_status().index_status.name == "INDEXED"
    assert heap.frozen() > 10_000 and gc.get_freeze_count() > 0
    resp = _search(back, x)
    assert _frozen_counter(resp) == heap.frozen()
    assert _answers(resp) == want
    back.close()
    assert gc.get_freeze_count() == 0


def test_owners_settle_and_release_from_many_threads():
    """While an owner is settled the heap stays frozen, whatever the
    other threads settle and release; the last release unfreezes."""
    class Owner:
        pass

    broken, done = [], []

    def work():
        for _ in range(10):
            o = Owner()
            heap.settle(o)
            if gc.get_freeze_count() == 0:
                broken.append(o)
            heap.release(o)
        done.append(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and len(done) == 16
    assert not broken
    assert gc.get_freeze_count() == 0 and heap.frozen() == 0
