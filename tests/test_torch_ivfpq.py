"""Parity of the port's IVFPQ model (the dense scan over the
reconstruction mirror, the gather tier over the residual-SQ8 or PQ
payload, OPQ) with the JAX package's, through the shared `.ivfpq.npz`
dump format.

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
    js, ts = JStore("vec", D), TStore("vec", D, device="cpu")
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
    tl = TIndex(TStore("vec", D, device="cpu"), PARAMS)
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


# ---- the dense scan over the reconstruction mirror ----

DENSE = {k: v for k, v in PARAMS.items() if k != "scan_mode"}     # "auto"


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a).astype(jnp.float32)))


def _mirror_close(tm, jm, rows):
    """The port's mirror equals the JAX one on `rows`: coordinates within
    one bf16 ulp (a coordinate's f32 sum may round to either neighbour),
    norms of the stored rows within f32 summation order, validity
    equal."""
    a, b = _f32(tm.recon)[rows], _f32(jm.recon)[rows]
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    assert np.all(np.abs(a - b) <= ulp)
    for name in ("recon_norms", "recon_bias"):
        np.testing.assert_allclose(_f32(getattr(tm, name))[rows],
                                   _f32(getattr(jm, name))[rows],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_f32(tm.recon_valid)[rows],
                                  _f32(jm.recon_valid)[rows])


def test_mirror_ingest_and_rebuild_match_jax(tmp_path):
    """Loading a JAX dump rebuilds the mirror the JAX model holds (its
    ingest-built one and its own rebuild); further ingest on the carried
    quantizers decodes the same rows, with norms of the stored rows."""
    x, _ = _corpus(8)
    js, ts = _stores(x)
    jm = JIndex(js, DENSE)
    jm.train(x[:2000])
    ids = np.arange(2500)
    jm.add(x[:2500], ids, ids)
    jm.dump(str(tmp_path / "j"))
    tm = TIndex(ts, DENSE)
    assert tm.load(str(tmp_path / "j")) == 2500
    jl = JIndex(JStore("vec", D), DENSE)
    jl.store.add(x)
    jl.store.flush_device()
    assert jl.load(str(tmp_path / "j")) == 2500
    for ref in (jm, jl):
        _mirror_close(tm, ref, ids)
    assert (_f32(tm.recon_valid)[2500:3000] >= 1e37).all()

    more = np.arange(2500, 3000)
    jm.add(x[2500:], more, more)
    tm.add(x[2500:], more, more)
    _mirror_close(tm, jm, np.arange(3000))
    assert tm.mem_bytes() > 3000 * D * 2


def _pair_search(jm, tm, q, k=10, sp=None, pen=None, dist_range=None,
                 validity=True):
    """The same request through both models: `pen` a doc-aligned
    penalty (else zeros), `validity` the engine's unfiltered fast form."""
    n = jm.store.n + 64
    p = np.zeros(n, np.float32) if pen is None else pen
    vn = (jm.indexed_count if validity and pen is None
          and dist_range is None else None)
    dj, docj, _ = jm.search(
        jnp.asarray(q), jnp.asarray(p), JSP.from_dict(sp), k,
        None if dist_range is None else jnp.asarray(dist_range, jnp.float32),
        validity_n=vn)
    dt, doct, _ = tm.search(
        torch.from_numpy(q), torch.from_numpy(p), TSP.from_dict(sp), k,
        None if dist_range is None else torch.tensor(dist_range),
        validity_n=vn)
    return ((np.asarray(dj), np.asarray(docj)),
            (dt.numpy(), np.asarray(doct)))


def _dense_agree(a, b, rerank=True):
    """Each side's distances of its own chosen ids, sorted: exact f32
    distances with the rerank, selection scores without it."""
    (da, ia), (db, ib) = a, b
    np.testing.assert_array_equal(ia < 0, ib < 0)
    live = ia >= 0
    tol = dict(rtol=1e-5, atol=1e-4) if rerank else dict(rtol=1e-3,
                                                          atol=1e-3)
    np.testing.assert_allclose(np.sort(db, 1)[live], np.sort(da, 1)[live],
                               **tol)
    overlap = np.mean([len(set(x) & set(y)) / max(1, len(set(x) - {-1}))
                       for x, y in zip(ia, ib)])
    assert overlap >= 0.9, overlap


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_dense_search_matches_jax(tmp_path, metric):
    """Dense searches of a JAX model and of the port's load of its dump:
    unfiltered, with a filter penalty, with a score range, without the
    rerank, then after a delete and a re-add of the same vids."""
    params = dict(DENSE, metric_type="InnerProduct" if metric == "ip"
                  else "L2")
    x, q = _corpus(9)
    js, ts = _stores(x)
    jm = JIndex(js, params)
    jm.train(x[:2000])
    ids = np.arange(3000)
    jm.add(x, ids, ids)
    jm.dump(str(tmp_path / "j"))
    tm = TIndex(ts, params)
    assert tm.load(str(tmp_path / "j")) == 3000
    assert tm.scan_mode(TSP()) == jm.scan_mode(JSP()) == "dense"

    _dense_agree(*_pair_search(jm, tm, q))
    _dense_agree(*_pair_search(jm, tm, q, sp={"has_rank": False}),
                 rerank=False)
    pen = np.where(np.random.default_rng(10).random(3064) < 0.3, 3.0e38,
                   0.0).astype(np.float32)
    a, b = _pair_search(jm, tm, q, pen=pen)
    _dense_agree(a, b)
    assert not np.isin(b[1], np.flatnonzero(pen)).any()
    _dense_agree(*_pair_search(jm, tm, q, sp={"has_rank": False}, pen=pen),
                 rerank=False)
    lo, hi = (0.5, 3.0) if metric == "l2" else (-60.0, -5.0)
    a, b = _pair_search(jm, tm, q, 5, dist_range=[lo, hi])
    live = b[0] < 1e37
    assert live.any() and np.all((b[0][live] >= lo) & (b[0][live] <= hi))
    _dense_agree(a, b)

    # delete, then re-add the same vids with moved rows
    dead = np.arange(0, 3000, 7)
    moved = (x[dead] + 0.05).astype(np.float32)
    for m in (jm, tm):
        m.delete(dead)
    a, b = _pair_search(jm, tm, q)
    _dense_agree(a, b)
    assert not np.isin(b[1], dead).any()
    js.update(dead, moved)
    ts.update(dead, moved)
    for m in (jm, tm):
        m.add(moved, dead, dead)
    _dense_agree(*_pair_search(jm, tm, q))


def test_dense_search_multi_vid_store(tmp_path):
    """A store with two vids per doc: the dense scan selects vids and maps
    them to docids on the host, in both packages alike."""
    x, q = _corpus(11, n=2400)
    js = JStore("vec", D, multi_vids=True)
    ts = TStore("vec", D, multi_vids=True, device="cpu")
    vids = np.arange(2400)
    docs = vids // 2
    for s in (js, ts):
        s.add(x)
        s.flush_device()
        for doc in range(1200):
            s.vid_mgr.note(doc, np.array([2 * doc, 2 * doc + 1]))
    jm = JIndex(js, DENSE)
    jm.train(x[:2000])
    jm.add(x, vids, docs)
    jm.dump(str(tmp_path / "j"))
    tm = TIndex(ts, DENSE)
    assert tm.load(str(tmp_path / "j")) == 2400
    a, b = _pair_search(jm, tm, q)
    _dense_agree(a, b)
    assert b[1].max() < 1200 and (b[1] >= 0).all()
    pen = np.zeros(1200 + 64, np.float32)
    pen[::3] = 3.0e38
    a, b = _pair_search(jm, tm, q, pen=pen)
    _dense_agree(a, b)
    assert not np.isin(b[1], np.arange(0, 1200, 3)).any()


@pytest.mark.parametrize("budget,mode", [(8 << 30, "dense"), (1, "gather")])
def test_scan_mode_auto_resolves_as_jax(monkeypatch, budget, mode):
    """"auto" is dense while the mirror fits DENSE_BYTES_BUDGET, in both
    packages; an explicit request wins; without a mirror, gather."""
    for mod in (jivfpq, tivfpq):
        monkeypatch.setattr(mod, "DENSE_BYTES_BUDGET", budget)
    x, _ = _corpus(12, n=600)
    js, ts = _stores(x)
    jm, tm = JIndex(js, DENSE), TIndex(ts, DENSE)
    for sp in ({}, {"scan_mode": "auto"}, {"scan_mode": "gather"},
               {"scan_mode": "dense"}):
        assert (tm.scan_mode(TSP.from_dict(sp))
                == jm.scan_mode(JSP.from_dict(sp)))
    assert tm.scan_mode(TSP()) == mode
    for m in (jm, tm):
        m.release_recon()
    assert tm.scan_mode(TSP.from_dict({"scan_mode": "dense"})) == "gather"
    assert jm.scan_mode(JSP.from_dict({"scan_mode": "dense"})) == "gather"
    assert tm.recon.shape[0] == 8


# ---- OPQ ----

def test_opq_init_matches_jax_up_to_column_signs():
    """eigh fixes each eigenvector up to its sign only.  The trailing
    columns belong to close eigenvalues, which turn a covariance summed
    in another f32 order into ~1e-4 changes of those vectors: atol
    1e-3."""
    x, _ = _corpus(13, n=1500)
    jm = JIndex(JStore("vec", D), DENSE)
    tm = TIndex(TStore("vec", D, device="cpu"), DENSE)
    rj = np.asarray(jm._train_opq_init(jnp.asarray(x)))
    rt = tm._train_opq_init(torch.from_numpy(x)).numpy()
    signs = np.sign((rj * rt).sum(0))
    np.testing.assert_allclose(rt * signs, rj, atol=1e-3)
    np.testing.assert_allclose(rt.T @ rt, np.eye(D), atol=1e-5)


def _fixed_train_pq(pq_mod, codebooks_of):
    """A deterministic stand-in for train_pq (codewords = strided rows of
    each subspace), so the refinement's own steps are compared without
    the two packages' k-means draws."""
    def train(x, M, *, nbits=8, iters=12, seed=0):
        xs = np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                        np.float32)
        ksub = 1 << nbits
        sel = np.linspace(0, xs.shape[0] - 1, ksub).astype(np.int64)
        cb = xs[sel].reshape(ksub, M, -1).transpose(1, 0, 2)
        return codebooks_of(np.ascontiguousarray(cb))
    return train


def test_refine_opq_matches_jax_from_carried_state(monkeypatch):
    """_refine_opq from the same rotated train set, centroids, residuals
    and codebooks: the same codebooks after two rounds; the port's
    rotation is the JAX init rotation times the JAX package's R (the
    port keeps the product, ROADMAP.md C3).  Two rounds, not the four
    of training: on this set the third round meets a near-tie in an
    argmin that f32 summation order decides, and the two sides part."""
    from gamma_tpu.ops import pq as jpq
    from gamma_tpu_torch.ops import pq as tpq
    monkeypatch.setattr(jpq, "train_pq", _fixed_train_pq(
        jpq, lambda cb: jpq.PQCodebooks(jnp.asarray(cb), jnp.asarray(
            (cb * cb).sum(-1)))))
    monkeypatch.setattr(tpq, "train_pq", _fixed_train_pq(
        tpq, lambda cb: tpq.codebooks_from(torch.from_numpy(cb))))
    x, _ = _corpus(14, n=1500)
    params = dict(DENSE, has_opq=True)
    jm = JIndex(JStore("vec", D), params)
    tm = TIndex(TStore("vec", D, device="cpu"), params)
    init = np.asarray(jm._train_opq_init(jnp.asarray(x)))
    xd = (x @ init).astype(np.float32)
    cents = xd[np.linspace(0, 1499, 16).astype(np.int64)]
    cn = (cents * cents).sum(1)
    assign = np.argmin(((xd[:, None] - cents[None]) ** 2).sum(-1), 1)
    res = (xd - cents[assign]).astype(np.float32)
    jm.opq_rot, jm.centroids, jm.cent_norms = (
        jnp.asarray(init), jnp.asarray(cents), jnp.asarray(cn))
    jm.pq = jpq.train_pq(res, 8)
    tm.opq_rot, tm.centroids, tm.cent_norms = (
        torch.tensor(init), torch.tensor(cents), torch.tensor(cn))
    tm.pq = tpq.train_pq(torch.from_numpy(res), 8)
    jm._refine_opq(jnp.asarray(xd), jnp.asarray(res), iters=2)
    tm._refine_opq(torch.from_numpy(xd), torch.from_numpy(res), iters=2)
    np.testing.assert_allclose(tm.pq.codebooks.numpy(),
                               np.asarray(jm.pq.codebooks), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tm.opq_rot.numpy(),
                               init @ np.asarray(jm.opq_rot), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("payload", ["sq8", "pq"])
def test_jax_opq_dump_searched_by_both(tmp_path, jax_tpu_path, payload):
    """A JAX model trained with OPQ: the port loads its rotation with the
    dump and answers like it, dense and gather."""
    params = dict(DENSE, has_opq=True, gather_payload=payload)
    x, q = _corpus(15)
    js, ts = _stores(x)
    jm = JIndex(js, params)
    jm.train(x[:2000])
    ids = np.arange(3000)
    jm.add(x, ids, ids)
    assert jm.opq_rot is not None and jm.sq_active == (payload == "sq8")
    jm.dump(str(tmp_path / "j"))
    tm = TIndex(ts, params)
    assert tm.load(str(tmp_path / "j")) == 3000
    np.testing.assert_array_equal(tm.opq_rot.numpy(), np.asarray(jm.opq_rot))
    _mirror_close(tm, jm, ids)
    _dense_agree(*_pair_search(jm, tm, q, sp={"scan_mode": "dense"}))
    sp = {"scan_mode": "gather", "recall_num": 300}
    a, b = _pair_search(jm, tm, q, sp=sp)
    if payload == "sq8":
        _agree(a, b)
    else:
        _same_quality(x, q, a, b)


def test_opq_fresh_training_serves_dense_and_gather():
    """The port training OPQ itself: an orthogonal rotation, and recall
    against exact search in dense and gather mode at least the JAX
    package's less 0.03."""
    x, q = _corpus(16)
    js, ts = _stores(x)
    ids = np.arange(x.shape[0])
    params = dict(DENSE, has_opq=True)
    jm, tm = JIndex(js, params), TIndex(ts, params)
    for m in (jm, tm):
        m.train(x)
        m.add(x, ids, ids)
    rot = tm.opq_rot.numpy()
    np.testing.assert_allclose(rot.T @ rot, np.eye(D), atol=1e-4)
    gt = np.argsort(_exact(x, q, np.tile(ids, (q.shape[0], 1))), 1)[:, :10]

    def recall(doc):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(doc, gt)])

    for sp in ({"scan_mode": "dense"}, {"scan_mode": "gather"}):
        a, b = _pair_search(jm, tm, q, sp=sp)
        r_t, r_j = recall(b[1]), recall(a[1])
        assert r_t >= 0.9 and r_t >= r_j - 0.03, (sp, r_t, r_j)


def test_opq_quantizers_fit_the_final_rotation():
    """With OPQ the coarse quantizer is fit on the rows under the final
    rotation (ROADMAP.md C3): the rotated rows' coarse quantization error
    stays within 1.5x of the same model's without OPQ (a rotation moves
    it little).  Centroids left where the init rotation put the rows
    give ~4x more on this corpus."""
    from gamma_tpu_torch.ops import kmeans as tkm
    x, _ = _corpus(17)
    err = {}
    for opq in (False, True):
        m = TIndex(TStore("vec", D, device="cpu"),
                   dict(DENSE, has_opq=opq))
        m.train(x)
        xr = m._rotate(torch.from_numpy(x))
        a = tkm.assign_nearest(xr, m.centroids, m.cent_norms)
        err[opq] = float(((xr - m.centroids[a]) ** 2).sum(1).mean())
    assert err[True] <= 1.5 * err[False], err


# ---------------------------------------------------------------------
# train(coarse=...), encode_batch, build_sq_sidecar
# ---------------------------------------------------------------------

@pytest.mark.parametrize("with_norms", [False, True])
def test_train_with_given_coarse_quantizer(with_norms):
    """train(x, coarse=(centroids[, cent_norms])) takes the given coarse
    quantizer instead of running k-means, in both packages: the same
    centroids and norms, hence the same list for every row; the port's
    codebooks, fit on those residuals, serve."""
    x, q = _corpus(20)
    js, ts = _stores(x)
    rng = np.random.default_rng(20)
    cents = x[rng.choice(3000, 16, replace=False)].copy()
    norms = (cents.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    coarse = (cents, norms) if with_norms else (cents,)
    jm, tm = JIndex(js, PARAMS), TIndex(ts, PARAMS)
    jm.train(x[:2000], coarse=coarse)
    tm.train(x[:2000], coarse=coarse)
    assert tm.trained() and tm.sq_active == jm.sq_active
    np.testing.assert_array_equal(tm.centroids.numpy(), cents)
    np.testing.assert_array_equal(np.asarray(jm.centroids), cents)
    np.testing.assert_allclose(tm.cent_norms.numpy(),
                               np.asarray(jm.cent_norms), rtol=1e-6)
    jl = jm.encode_batch(x[:500])[0]
    tl = tm.encode_batch(x[:500])[0]
    assert (tl == jl).mean() >= 0.998        # a tie between two lists
    ids = np.arange(3000)
    tm.add(x, ids, ids)
    _, doc = _search_t(tm, x[:100], 1)
    assert (doc[:, 0] == np.arange(100)).mean() >= 0.97


def test_train_coarse_survives_opq_refit():
    """With OPQ the port fits its quantizers a second time under the
    final rotation; a given coarse quantizer is kept both times."""
    x, _ = _corpus(21)
    _, ts = _stores(x)
    cents = np.random.default_rng(21).normal(size=(16, D)).astype(np.float32)
    tm = TIndex(ts, dict(PARAMS, has_opq=True))
    tm.train(x[:2000], coarse=(cents,))
    np.testing.assert_array_equal(tm.centroids.numpy(), cents)
    assert tm.opq_rot is not None


def test_encode_batch_matches_jax(tmp_path):
    """encode_batch on one trained state (the JAX model's dump): the same
    lists, the same padded shapes, the same PQ codes but for encode ties,
    mirror rows and norms to bf16 / 1e-4."""
    x, _ = _corpus(22)
    js, ts = _stores(x)
    jm = JIndex(js, PARAMS)
    jm.train(x[:2000])
    jm.dump(str(tmp_path))
    tm = TIndex(ts, PARAMS)
    tm.load(str(tmp_path))
    tm._trained = True
    for rows in (x[:300], torch.from_numpy(x[300:1400])):
        jl, jc, jr, jn = jm.encode_batch(np.asarray(rows))
        tl, tc, tr, tn = tm.encode_batch(rows)
        n = rows.shape[0]
        assert tl.shape == (n,) and tc.shape == tuple(jc.shape)
        assert tr.shape == tuple(jr.shape) and tn.shape == tuple(jn.shape)
        assert tr.dtype == torch.bfloat16
        np.testing.assert_array_equal(tl, jl)
        same = (tc.numpy()[:n] == np.asarray(jc)[:n])
        assert same.mean() >= 0.999, same.mean()
        ok = same.all(1)
        np.testing.assert_allclose(tr.float().numpy()[:n][ok],
                                   _f32(jr)[:n][ok], rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(tn.numpy()[:n][ok],
                                   np.asarray(jn)[:n][ok], rtol=1e-4)


@pytest.mark.parametrize("opq", [False, True])
def test_build_sq_sidecar_matches_jax(tmp_path, jax_tpu_path, opq):
    """A model that ingested on the PQ payload is promoted to the SQ8
    tier after the fact, in both packages, from one dump: the same fitted
    ranges, the same codes on live slots (a code may differ by one step
    where the bf16 mirror row sits on a rounding edge), the same norms,
    and the same search afterwards."""
    params = dict(PARAMS, gather_payload="pq", has_opq=opq)
    x, q = _corpus(23)
    js, ts = _stores(x)
    jm = JIndex(js, params)
    jm.train(x[:2000])
    ids = np.arange(3000)
    jm.add(x, ids, ids)
    jm.delete(np.arange(0, 40))
    jm.dump(str(tmp_path))
    tm = TIndex(ts, params)
    assert tm.load(str(tmp_path)) == 3000 and not tm.sq_active
    assert jm.build_sq_sidecar() and tm.build_sq_sidecar()
    assert tm.sq_active and tm.sq_payload == "sq8"
    np.testing.assert_allclose(tm.sq_scale.numpy(), np.asarray(jm.sq_scale),
                               rtol=1e-4)
    np.testing.assert_allclose(tm.sq_off.numpy(), np.asarray(jm.sq_off),
                               rtol=1e-4, atol=1e-5)
    assert tuple(tm.sq_codes.shape) == tuple(jm.sq_codes.shape)
    lens = tm.state.lens.numpy()
    live = ((np.arange(tm.sq_codes.shape[1])[None, :] < lens[:, None])
            & (tm.state.vids.numpy()[:, :tm.sq_codes.shape[1]] >= 0))
    tc = tm.sq_codes.numpy()[live].astype(np.int32)
    jc = np.asarray(jm.sq_codes)[live].astype(np.int32)
    assert np.abs(tc - jc).max() <= 1 and (tc == jc).mean() >= 0.99
    np.testing.assert_allclose(tm.sq_norms.numpy()[live],
                               np.asarray(jm.sq_norms)[live], rtol=2e-3)
    # (a code one step apart moves that row's distance by up to a step
    # of its range times the query's offset: 5e-3 of the distance here)
    (jd, jdoc), (td, tdoc) = _search_j(jm, q), _search_t(tm, q)
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=5e-3,
                               atol=5e-3)
    assert np.mean([len(set(a) & set(b)) / len(a)
                    for a, b in zip(jdoc, tdoc)]) >= 0.95
    # the promoted model goes on ingesting into the sidecar
    more = np.arange(3000, 3000 + 64)
    tm.store.add(x[:64])
    tm.store.flush_device()
    tm.add(x[:64], more, more)
    assert tm.sq_active and tm.sq_codes.shape[1] >= tm._cap_eff()


def test_build_sq_sidecar_over_budget(monkeypatch):
    x, _ = _corpus(24, n=1500)
    _, ts = _stores(x)
    tm = TIndex(ts, dict(PARAMS, gather_payload="pq"))
    tm.train(x[:1000])
    ids = np.arange(1500)
    tm.add(x, ids, ids)
    monkeypatch.setattr(tivfpq, "SQ_BYTES_BUDGET", 1)
    assert tm.build_sq_sidecar() is False and not tm.sq_active
