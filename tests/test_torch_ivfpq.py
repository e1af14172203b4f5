"""Parity of the port's IVFPQ model (gather tier, residual-SQ8 or PQ
payload) with the JAX package's, through the shared `.ivfpq.npz` dump
format.

A JAX IVFPQIndex is trained and ingested; the port loads its dump
(gamma_tpu_torch.convert) and both answer the same queries; the port's
dump loads back into the JAX package; further ingest, deletes and
compaction then leave both posting states identical.  The JAX side
searches on its TPU code path with the kernels interpreted, so both
sides round the scan's bf16 operands alike."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.config import SearchParams as JSP
from gamma_tpu.index import ivfpq as jivfpq
from gamma_tpu.index.ivfpq import IVFPQIndex as JIndex
from gamma_tpu.ops import pallas_adc as jadc
from gamma_tpu.ops import pallas_gadc as jgadc
from gamma_tpu.ops import pallas_gsq as jgsq
from gamma_tpu_torch.index import ivfpq as tivfpq
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
    monkeypatch.setattr(jgadc, "grouped_adc", functools.partial(
        jgadc.grouped_adc, interpret=True))
    monkeypatch.setattr(jadc, "adc_scan_pallas", functools.partial(
        jadc.adc_scan_pallas, interpret=True))


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


def _search_j(m, q, k=10, sp=None, dist_range=None):
    pen = jnp.zeros(m.store.n + 64, jnp.float32)
    d, doc, _ = m.search(
        jnp.asarray(q), pen, JSP.from_dict(sp), k,
        None if dist_range is None else jnp.asarray(dist_range, jnp.float32),
        validity_n=None if dist_range is not None else m.indexed_count)
    return np.asarray(d), np.asarray(doc)


def _search_t(m, q, k=10, sp=None, dist_range=None):
    pen = torch.zeros(m.store.n + 64)
    d, doc, _ = m.search(
        torch.from_numpy(q), pen, TSP.from_dict(sp), k,
        None if dist_range is None else torch.tensor(dist_range),
        validity_n=None if dist_range is not None else m.indexed_count)
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


# the PQ payload: B3 at M*ksub % 128 == 0 (M 8 x ksub 256), B4 otherwise
# (M 12 x ksub 16 = 192; coarser codes tie exactly too often for a
# parity test of the candidate select)
PQ_CONFIGS = {
    "b3": dict(PARAMS, gather_payload="pq"),
    "b4": dict(PARAMS, gather_payload="pq", nsubvector=12, nbits_per_idx=4),
}


def _exact(x, q, doc):
    """Exact f64 L2 distances of each chosen id (inf for -1)."""
    d = ((q[:, None, :].astype(np.float64)
          - x[np.maximum(doc, 0)].astype(np.float64)) ** 2).sum(-1)
    return np.where(doc >= 0, d, np.inf)


def _same_quality(x, q, a, b):
    """Both sides chose equally good ids: the sorted exact distances of
    each side's ids agree (near-ties may pick different ids)."""
    ea, eb = np.sort(_exact(x, q, a[1]), 1), np.sort(_exact(x, q, b[1]), 1)
    np.testing.assert_array_equal(np.isfinite(ea), np.isfinite(eb))
    ok = np.isfinite(ea)
    np.testing.assert_allclose(eb[ok], ea[ok], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("cfg", sorted(PQ_CONFIGS))
def test_pq_payload_cross_load_and_search(tmp_path, jax_tpu_path, cfg):
    """The PQ payload both ways through the dump: no sidecar is written,
    the search (exact rerank on, off, and with a score range) agrees
    with the JAX package's, and the port's dump loads back into it."""
    params = PQ_CONFIGS[cfg]
    x, q = _corpus(5)
    js, ts = _stores(x)
    jm = JIndex(js, params)
    jm.train(x[:2000])
    ids = np.arange(3000)
    jm.add(x, ids, ids)
    assert not jm.sq_active
    jm.dump(str(tmp_path / "j"))
    tm = TIndex(ts, params)
    assert tm.load(str(tmp_path / "j")) == 3000
    assert not tm.sq_active and tm._cap_eff() == jm._cap_eff()
    # exact ADC ties (codes shared by several docs) may admit different
    # docs on each side: without the rerank the ADC distances agree, and
    # with it (recall_num 300 keeps the heap's edge away from the top 10)
    # the chosen docs are equally near
    a = _search_j(jm, q, sp={"has_rank": False})
    b = _search_t(tm, q, sp={"has_rank": False})
    np.testing.assert_allclose(np.sort(b[0], 1), np.sort(a[0], 1),
                               rtol=1e-3, atol=1e-3)
    sp = {"recall_num": 300}
    _same_quality(x, q, _search_j(jm, q, sp=sp), _search_t(tm, q, sp=sp))
    rng_ = [0.5, 3.0]
    a = _search_j(jm, q, 5, dist_range=rng_)
    b = _search_t(tm, q, 5, dist_range=rng_)
    live = b[0] < 1e37
    assert live.any() and np.all((b[0][live] >= 0.5) & (b[0][live] <= 3.0))
    _same_quality(x, q, a, b)
    # port → JAX: the same arrays, no sq_* keys
    tm.dump(str(tmp_path / "t"))
    with np.load(tmp_path / "t" / "vec.ivfpq.npz") as z:
        assert not any(k.startswith("sq_") for k in z.files)
    jm2 = JIndex(JStore("vec", D), params)
    jm2.store.add(x)
    jm2.store.flush_device()
    assert jm2.load(str(tmp_path / "t")) == 3000
    _same_quality(x, q, _search_j(jm2, q, sp=sp), _search_t(tm, q, sp=sp))


def test_pq_payload_fresh_training_recall():
    """The port training its own PQ-payload model: never allocates the
    sidecar, and reaches the JAX package's recall."""
    x, q = _corpus(6)
    js, ts = _stores(x)
    ids = np.arange(x.shape[0])
    params = PQ_CONFIGS["b3"]
    jm, tm = JIndex(js, params), TIndex(ts, params)
    for m in (jm, tm):
        m.train(x)
        m.add(x, ids, ids)
    assert tm.sq_codes is None and tm.sq_scale is None
    gt = np.argsort(_exact(x, q, np.tile(ids, (q.shape[0], 1))), 1)[:, :10]

    def recall(doc):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(doc, gt)])

    r_t, r_j = recall(_search_t(tm, q)[1]), recall(_search_j(jm, q)[1])
    assert r_t >= 0.9 and r_t >= r_j - 0.03, (r_t, r_j)


@pytest.mark.parametrize("budget,why", [(1, "init"), (600_000, "grow")])
def test_sq8_budget_drop_falls_back_to_adc(tmp_path, jax_tpu_path,
                                           monkeypatch, budget, why):
    """Past SQ_BYTES_BUDGET both packages drop the sidecar (at train time,
    or when a later add would grow it past the budget) and serve the
    gather tier by ADC; the JAX package's dump then loads into the port
    and both agree, and the port's own model reaches the JAX recall."""
    for mod in (jivfpq, tivfpq):
        monkeypatch.setattr(mod, "SQ_BYTES_BUDGET", budget)
    x, q = _corpus(7)
    js, ts = _stores(x)
    ids = np.arange(x.shape[0])
    jm, tm = JIndex(js, PARAMS), TIndex(ts, PARAMS)
    for m in (jm, tm):
        m.train(x[:2000])
        assert m.sq_active == (why == "grow")
        m.add(x, ids, ids)
        assert not m.sq_active
    jm.dump(str(tmp_path / "j"))
    tl = TIndex(TStore("vec", D), PARAMS)
    tl.store.add(x)
    tl.store.flush_device()
    assert tl.load(str(tmp_path / "j")) == x.shape[0]
    assert not tl.sq_active
    _agree(_search_j(jm, q), _search_t(tl, q))
    gt = np.argsort(_exact(x, q, np.tile(ids, (q.shape[0], 1))), 1)[:, :10]

    def recall(doc):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(doc, gt)])

    r_t, r_j = recall(_search_t(tm, q)[1]), recall(_search_j(jm, q)[1])
    assert r_t >= 0.9 and r_t >= r_j - 0.03, (r_t, r_j)
