"""Parity of the port's IVFPQ model (residual-SQ8 gather tier) with the
JAX package's, through the shared `.ivfpq.npz` dump format.

A JAX IVFPQIndex is trained and ingested; the port loads its dump
(gamma_tpu_torch.convert) and both answer the same queries; the port's
dump loads back into the JAX package; further ingest, deletes and
compaction then leave both posting states identical.  The JAX side
searches on its TPU code path with the kernels interpreted, so both
sides round the scan's query operand to bf16 alike."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.config import SearchParams as JSP
from gamma_tpu.index.ivfpq import IVFPQIndex as JIndex
from gamma_tpu.ops import pallas_gsq as jgsq
from gamma_tpu.vector.raw_store import RawVectorStore as JStore
from gamma_tpu_torch.config import SearchParams as TSP
from gamma_tpu_torch.index.ivfpq import IVFPQIndex as TIndex
from gamma_tpu_torch.vector.raw_store import RawVectorStore as TStore

D = 32
PARAMS = {"ncentroids": 16, "nsubvector": 8, "nprobe": 8,
          "scan_mode": "gather", "bucket_init_size": 64}


@pytest.fixture
def jax_tpu_path(monkeypatch):
    """JAX IVFPQIndex.search on its TPU branch, kernels interpreted."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jgsq, "grouped_sq_scan", functools.partial(
        jgsq.grouped_sq_scan, interpret=True))


def _corpus(seed, n=3000):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(24, D)).astype(np.float32) * 2.0
    x = (centers[rng.integers(0, 24, n)]
         + 0.3 * rng.normal(size=(n, D))).astype(np.float32)
    q = (x[rng.choice(n, 20, replace=False)]
         + 0.1 * rng.normal(size=(20, D))).astype(np.float32)
    return x, q


def _stores(x):
    js, ts = JStore("vec", D), TStore("vec", D)
    for s in (js, ts):
        s.add(x)
        s.flush_device()
    return js, ts


def _search_j(m, q, k=10):
    pen = jnp.zeros(m.store.n + 64, jnp.float32)
    d, doc, _ = m.search(jnp.asarray(q), pen, JSP(), k,
                         validity_n=m.indexed_count)
    return np.asarray(d), np.asarray(doc)


def _search_t(m, q, k=10):
    pen = torch.zeros(m.store.n + 64)
    d, doc, _ = m.search(torch.from_numpy(q), pen, TSP(), k,
                         validity_n=m.indexed_count)
    return d.numpy(), doc.numpy()


def _agree(a, b):
    (da, ia), (db, ib) = a, b
    np.testing.assert_allclose(np.sort(db, 1), np.sort(da, 1), rtol=1e-3,
                               atol=1e-3)
    overlap = np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(ia, ib)])
    assert overlap >= 0.95, overlap


def _lists(state):
    lens = np.asarray(state.lens)
    docs = np.asarray(state.docids)
    return lens, [set(docs[i, :lens[i]].tolist()) - {-1}
                  for i in range(lens.size)]


def test_cross_load_search_and_ingest(tmp_path, jax_tpu_path):
    x, q = _corpus(0)
    js, ts = _stores(x)
    jm = JIndex(js, PARAMS)
    jm.train(x[:2000])
    ids = np.arange(2500)
    jm.add(x[:2500], ids, ids)
    jm.dump(str(tmp_path / "j"))

    # JAX → port
    tm = TIndex(ts, PARAMS)
    assert tm.load(str(tmp_path / "j")) == 2500
    assert tm.sq_active and tm._cap_eff() == jm._cap_eff()
    _agree(_search_j(jm, q), _search_t(tm, q))

    # port → JAX
    tm.dump(str(tmp_path / "t"))
    jm2 = JIndex(JStore("vec", D), PARAMS)
    jm2.store.add(x)
    jm2.store.flush_device()
    assert jm2.load(str(tmp_path / "t")) == 2500
    _agree(_search_j(jm2, q), _search_t(tm, q))

    # the same further ingest → the same lens and per-list docid sets
    more = np.arange(2500, 3000)
    jm.add(x[2500:], more, more)
    tm.add(x[2500:], more, more)
    jl, jsets = _lists(jm.state)
    tl, tsets = _lists(tm.state)
    np.testing.assert_array_equal(tl, jl)
    assert tsets == jsets
    _agree(_search_j(jm, q), _search_t(tm, q))

    # deletes + compaction (>= 30% dead) keep both identical
    dead = np.random.default_rng(1).choice(3000, 1000, replace=False)
    for m in (jm, tm):
        m.delete(dead)
        m.compact()
    jl, jsets = _lists(jm.state)
    tl, tsets = _lists(tm.state)
    np.testing.assert_array_equal(tl, jl)
    assert tsets == jsets
    assert tl.sum() == 2000
    d, doc = _search_t(tm, q)
    assert not np.isin(doc[doc >= 0], dead).any()
    _agree(_search_j(jm, q), (d, doc))


def test_fresh_training_recall():
    """A port training from scratch (its own k-means draws) is judged by
    recall against exact search and by the JAX package's recall."""
    x, q = _corpus(2)
    js, ts = _stores(x)
    ids = np.arange(x.shape[0])
    jm, tm = JIndex(js, PARAMS), TIndex(ts, PARAMS)
    for m in (jm, tm):
        m.train(x)
        m.add(x, ids, ids)
    gt = np.argsort(((q[:, None, :].astype(np.float64) - x[None]) ** 2
                     ).sum(-1), 1)[:, :10]

    def recall(doc):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(doc, gt)])

    r_t = recall(_search_t(tm, q)[1])
    r_j = recall(_search_j(jm, q)[1])
    assert r_t >= 0.9 and r_t >= r_j - 0.03, (r_t, r_j)


def test_untrained_brute_fallback_and_score_range():
    """Before training the model answers by exact flat search; a score
    range is fused into both the fallback and the trained scan."""
    x, q = _corpus(3, n=800)
    _, ts = _stores(x)
    tm = TIndex(ts, PARAMS)
    pen = torch.zeros(ts.device.shape[0])
    d, doc, _ = tm.search(torch.from_numpy(q), pen, TSP(), 5)
    ex = ((q[:, None, :].astype(np.float64)
           - ts.device[:800].float().numpy()[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d.numpy(), np.sort(ex, 1)[:, :5], rtol=1e-4,
                               atol=1e-4)
    ids = np.arange(800)
    tm.train(x)
    tm.add(x, ids, ids)
    rng = torch.tensor([0.5, 3.0])
    d, doc, _ = tm.search(torch.from_numpy(q), pen, TSP(), 5, rng)
    live = d.numpy() < 1e37
    assert live.any()
    assert np.all((d.numpy()[live] >= 0.5) & (d.numpy()[live] <= 3.0))


@pytest.mark.parametrize("params,match", [
    ({"scan_mode": "dense"}, "A.1"),
    ({"has_opq": True}, "A.2"),
    ({"gather_payload": "pq"}, "B3"),
])
def test_unported_options_raise(params, match):
    with pytest.raises(NotImplementedError, match=match):
        TIndex(TStore("vec", D), dict(PARAMS, **params))


def test_dense_request_raises():
    x, _ = _corpus(4, n=600)
    _, ts = _stores(x)
    tm = TIndex(ts, PARAMS)
    tm.train(x)
    sp = TSP.from_dict({"scan_mode": "dense"})
    with pytest.raises(NotImplementedError, match="A.1"):
        tm.search(torch.from_numpy(x[:2]), torch.zeros(600), sp, 3)
