"""The verify-skill recipe on both engines: create, ingest past
indexing_size (auto-train), self-retrieval, range + term hybrid, score
range, delete, dump and load — for IVFPQ on its default dense scan (with
and without OPQ) and on the gather tier over the SQ8 and the PQ payload,
for IVFPQ_FASTSCAN both ways, and for IVFFLAT (grouped scan and the
per-query one) and FLAT.  The port's engine runs on the CPU by
request (device="cpu"); without it, and without a card, it refuses to
start.

Cross-check: a JAX engine (native_persistence=False) writes a legacy
dump, and the port's engine loads it and answers like the JAX engine —
the same self-retrieval top-1, and per query the same sorted top-k
distances to 1e-3 relative.  The JAX engine searches on its TPU code
path with the kernels interpreted, so both round the scan's query
operand to bf16 alike."""

import functools
import os

import jax
import numpy as np
import pytest

import gamma_tpu
import gamma_tpu_torch
from gamma_tpu.ops import pallas_gadc as jgadc
from gamma_tpu.ops import pallas_gsq as jgsq

N, D = 3000, 32
PARAMS = {"ncentroids": 32, "nsubvector": 8, "nprobe": 12,
          "scan_mode": "gather"}
# the models the ADC kernels serve: (retrieval type, params)
ADC_MODELS = {
    "ivfpq_pq": ("IVFPQ", dict(PARAMS, gather_payload="pq")),
    "fastscan": ("IVFPQ_FASTSCAN", dict(PARAMS, nsubvector=16)),
}


@pytest.fixture
def jax_tpu_path(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jgsq, "grouped_sq_scan", functools.partial(
        jgsq.grouped_sq_scan, interpret=True))
    monkeypatch.setattr(jgadc, "grouped_adc", functools.partial(
        jgadc.grouped_adc, interpret=True))


def _corpus():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(16, D)).astype(np.float32)
    return (centers[rng.integers(0, 16, N)]
            + 0.1 * rng.normal(size=(N, D))).astype(np.float32)


def _open(pkg, path, **cfg):
    """A bare engine; the port's runs on the CPU here, by request."""
    kw = {"device": "cpu"} if pkg is gamma_tpu_torch else {}
    return pkg.GammaEngine(pkg.EngineConfig(path=str(path), **cfg), **kw)


def _engine(pkg, path, model="IVFPQ", params=PARAMS, **cfg):
    eng = _open(pkg, path, **cfg)
    dt = pkg.config.DataType
    eng.create_table(pkg.TableInfo(
        name="t",
        fields=[pkg.FieldInfo("price", dt.FLOAT, is_index=True),
                pkg.FieldInfo("tag", dt.STRING, is_index=True)],
        vectors=[pkg.VectorInfo("emb", D)],
        indexing_size=1000, retrieval_types=[model],
        retrieval_params=[params]))
    return eng


def _ingest(pkg, eng, x):
    docs = [pkg.Doc(key=f"k{i}", fields={"price": float(i % 500),
                                          "tag": f"t{i % 5}"},
                    vectors={"emb": x[i]}) for i in range(x.shape[0])]
    assert all(c == 0 for c in eng.add_or_update_docs(docs))
    eng.flush()


def _search(pkg, eng, q, k=10, **kw):
    vq = pkg.VectorQuery("emb", q, min_score=kw.pop("min_score", -np.inf),
                         max_score=kw.pop("max_score", np.inf))
    return eng.search(pkg.Request(vec_fields=[vq], topn=k, **kw)).results


def _top(results, k=10):
    ids = np.full((len(results), k), -1)
    dist = np.full((len(results), k), np.inf)
    for i, sr in enumerate(results):
        for j, it in enumerate(sr.result_items[:k]):
            ids[i, j], dist[i, j] = it.docid, it.score
    return ids, dist


def _recipe(pkg, eng, x):
    """The verify-skill checks; returns nothing, raises on failure."""
    _ingest(pkg, eng, x)
    assert eng.engine_status().index_status.name == "INDEXED"
    ids, _ = _top(_search(pkg, eng, x[:100]), 1)
    assert np.mean(ids[:, 0] == np.arange(100)) >= 0.99
    res = _search(pkg, eng, x[:30], fields=["price", "tag"],
                  range_filters=[pkg.RangeFilter("price", 100.0, 300.0)],
                  term_filters=[pkg.TermFilter("tag", "t1")])
    hits = [it for sr in res for it in sr.result_items]
    assert hits and all(100 <= it.attributes["price"] <= 300
                        and it.attributes["tag"] == "t1" for it in hits)
    res = _search(pkg, eng, x[:30], min_score=0.05, max_score=0.4)
    scores = [it.score for sr in res for it in sr.result_items]
    assert scores and all(0.05 <= s <= 0.4 for s in scores)
    assert eng.delete("k3") == 0 and eng.delete("k3") == -1
    ids, _ = _top(_search(pkg, eng, x[3:4]))
    assert 3 not in ids


def test_port_engine_recipe_native_dump_load(tmp_path):
    x = _corpus()
    eng = _engine(gamma_tpu_torch, tmp_path)
    _recipe(gamma_tpu_torch, eng, x)
    before = _top(_search(gamma_tpu_torch, eng, x[:50]))
    assert eng.dump() == 0
    eng.close()
    eng2 = _open(gamma_tpu_torch, tmp_path)
    assert eng2.load() == 0
    after = _top(_search(gamma_tpu_torch, eng2, x[:50]))
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])
    st = eng2.engine_status()
    assert st.doc_count == N - 1 and st.min_indexed_num == N
    assert eng2.get_doc_by_key("k3") is None
    assert eng2.get_doc_by_key("k4")["price"] == 4.0
    eng2.close()


def test_port_loads_jax_legacy_dump(tmp_path, jax_tpu_path):
    x = _corpus()
    jeng = _engine(gamma_tpu, tmp_path, native_persistence=False)
    _recipe(gamma_tpu, jeng, x)
    assert jeng.dump() == 0
    teng = _open(gamma_tpu_torch, tmp_path, native_persistence=False)
    assert teng.load() == 0
    q = x[:200]
    jids, jd = _top(_search(gamma_tpu, jeng, q))
    tids, td = _top(_search(gamma_tpu_torch, teng, q))
    np.testing.assert_array_equal(tids[:, 0], jids[:, 0])
    live = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), live)
    # atol: the norm expansion cancels ||q||^2 ~ 30, so near-zero
    # self-distances carry ~1e-5 of f32 round-off on either side
    np.testing.assert_allclose(np.sort(td, 1)[live], np.sort(jd, 1)[live],
                               rtol=1e-3, atol=1e-4)
    # filters and deletes carried across: k3 stays deleted
    assert teng.get_doc_by_key("k3") is None
    res = _search(gamma_tpu_torch, teng, q[:20],
                  range_filters=[gamma_tpu_torch.RangeFilter(
                      "price", 0.0, 99.0)], fields=["price"])
    assert all(it.attributes["price"] <= 99.0
               for sr in res for it in sr.result_items)
    jeng.close()
    teng.close()


def test_multi_field_merge_and_l2_sqrt(tmp_path):
    """Two vector clauses on one field merge by docid (summed score) and
    l2_sqrt reports sqrt distances."""
    x = _corpus()
    eng = _engine(gamma_tpu_torch, tmp_path)
    _ingest(gamma_tpu_torch, eng, x)
    pkg = gamma_tpu_torch
    one = eng.search(pkg.Request(vec_fields=[pkg.VectorQuery("emb", x[5])],
                                 topn=5)).results[0].result_items
    two = eng.search(pkg.Request(
        vec_fields=[pkg.VectorQuery("emb", x[5]),
                    pkg.VectorQuery("emb", x[5])], topn=5,
        multi_vector_rank=True)).results[0].result_items
    assert two[0].docid == one[0].docid == 5
    np.testing.assert_allclose(two[0].score, 2 * one[0].score, atol=1e-6)
    sq = eng.search(pkg.Request(vec_fields=[pkg.VectorQuery("emb", x[5])],
                                topn=5, l2_sqrt=True)).results[0]
    np.testing.assert_allclose(
        [it.score ** 2 for it in sq.result_items][1:],
        [it.score for it in one][1:], rtol=1e-4)
    eng.close()


def test_del_doc_by_query(tmp_path):
    x = _corpus()
    pkg = gamma_tpu_torch
    eng = _engine(pkg, tmp_path)
    _ingest(pkg, eng, x)
    n = eng.del_doc_by_query(pkg.Request(
        range_filters=[pkg.RangeFilter("price", 0.0, 9.0)]))
    assert n == 10 * (N // 500)
    res = _search(pkg, eng, x[:20], fields=["price"])
    assert all(it.attributes["price"] > 9.0
               for sr in res for it in sr.result_items)
    eng.close()


@pytest.mark.parametrize("cfg", sorted(ADC_MODELS))
def test_port_engine_adc_models_recipe_dump_load(tmp_path, cfg):
    """The recipe through the public API on the models the ADC kernels
    serve; a fresh engine loads the dump and answers identically."""
    model, params = ADC_MODELS[cfg]
    pkg = gamma_tpu_torch
    x = _corpus()
    eng = _engine(pkg, tmp_path, model, params)
    _recipe(pkg, eng, x)
    m = eng.vm.index_for("emb")
    assert type(m).__name__.startswith("IVFPQ") and not m.sq_active
    before = _top(_search(pkg, eng, x[:50]))
    assert eng.dump() == 0
    eng.close()
    eng2 = _open(pkg, tmp_path)
    assert eng2.load() == 0
    after = _top(_search(pkg, eng2, x[:50]))
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])
    assert eng2.engine_status().min_indexed_num == N
    eng2.close()


@pytest.mark.parametrize("cfg", sorted(ADC_MODELS))
def test_port_loads_jax_legacy_dump_adc_models(tmp_path, jax_tpu_path, cfg):
    """A JAX engine's dump of the same model loads into the port's engine,
    which then answers like it: the same self-retrieval top-1 and, per
    query, the same sorted top-k (reranked, exact) distances."""
    model, params = ADC_MODELS[cfg]
    x = _corpus()
    jeng = _engine(gamma_tpu, tmp_path, model, params,
                   native_persistence=False)
    _recipe(gamma_tpu, jeng, x)
    assert jeng.dump() == 0
    teng = _open(gamma_tpu_torch, tmp_path, native_persistence=False)
    assert teng.load() == 0
    q = x[:200]
    jids, jd = _top(_search(gamma_tpu, jeng, q))
    tids, td = _top(_search(gamma_tpu_torch, teng, q))
    np.testing.assert_array_equal(tids[:, 0], jids[:, 0])
    live = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), live)
    np.testing.assert_allclose(np.sort(td, 1)[live], np.sort(jd, 1)[live],
                               rtol=1e-3, atol=1e-4)
    assert teng.get_doc_by_key("k3") is None
    jeng.close()
    teng.close()


def test_engine_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    """Without a CUDA device the port's engine refuses to start unless
    the caller asks for the CPU; it never moves there on its own."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gamma_tpu_torch.EngineConfig(path=str(tmp_path))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gamma_tpu_torch.GammaEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gamma_tpu_torch.GammaEngine(cfg, device="cuda")
    eng = gamma_tpu_torch.GammaEngine(cfg, device="cpu")
    assert eng.device.type == "cpu"
    eng.close()


# the models on their default scan mode: (retrieval type, params)
DENSE_MODELS = {
    "ivfpq": ("IVFPQ", {"ncentroids": 32, "nsubvector": 8}),
    "ivfpq_opq": ("IVFPQ", {"ncentroids": 32, "nsubvector": 8,
                            "has_opq": True}),
    "fastscan": ("IVFPQ_FASTSCAN", {"ncentroids": 32, "nsubvector": 16}),
}


@pytest.mark.parametrize("cfg", sorted(DENSE_MODELS))
def test_port_engine_dense_default(tmp_path, cfg):
    """Default params resolve to the dense scan (scan_mode "auto"); the
    recipe passes on it and a fresh engine loads the dump, rebuilds the
    mirror and answers identically."""
    model, params = DENSE_MODELS[cfg]
    pkg = gamma_tpu_torch
    x = _corpus()
    eng = _engine(pkg, tmp_path, model, params)
    _recipe(pkg, eng, x)
    m = eng.vm.index_for("emb")
    assert m.scan_mode(pkg.config.SearchParams()) == "dense"
    before = _top(_search(pkg, eng, x[:50]))
    assert eng.dump() == 0
    eng.close()
    eng2 = _open(pkg, tmp_path)
    assert eng2.load() == 0
    after = _top(_search(pkg, eng2, x[:50]))
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])
    eng2.close()


@pytest.mark.parametrize("cfg", sorted(DENSE_MODELS))
def test_port_loads_jax_legacy_dump_dense(tmp_path, cfg):
    """A JAX engine on its default (dense) scan ingests, deletes and
    dumps; the port's engine loads it, rebuilds the mirror, and answers
    like it: the same top-1 and, per query, the same sorted (reranked,
    exact) distances.  The JAX engine runs no recipe checks: with OPQ
    its own training misses them (ROADMAP.md C3), and the point here is
    that both engines answer alike from one dump."""
    model, params = DENSE_MODELS[cfg]
    x = _corpus()
    jeng = _engine(gamma_tpu, tmp_path, model, params,
                   native_persistence=False)
    _ingest(gamma_tpu, jeng, x)
    assert jeng.delete("k3") == 0
    assert jeng.dump() == 0
    teng = _open(gamma_tpu_torch, tmp_path, native_persistence=False)
    assert teng.load() == 0
    assert teng.vm.index_for("emb").scan_mode(
        gamma_tpu_torch.config.SearchParams()) == "dense"
    q = x[:200]
    # the JAX OPQ model's selection scores are far from the distances
    # (C3), so its true neighbours sit at the edge of a 100-row candidate
    # pool, where the two sides' summation orders admit different rows:
    # a pool of 1000 holds them on both sides
    kw = ({"retrieval_params": {"recall_num": 1000}}
          if params.get("has_opq") else {})
    jids, jd = _top(_search(gamma_tpu, jeng, q, **kw))
    tids, td = _top(_search(gamma_tpu_torch, teng, q, **kw))
    np.testing.assert_array_equal(tids[:, 0], jids[:, 0])
    live = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), live)
    np.testing.assert_allclose(np.sort(td, 1)[live], np.sort(jd, 1)[live],
                               rtol=1e-5, atol=1e-4)
    assert teng.get_doc_by_key("k3") is None
    assert 3 not in tids
    jeng.close()
    teng.close()


# the exact models: (retrieval type, params)
# (IVFFLAT probes ncentroids/16 lists unless the request says otherwise,
# as in the JAX package)
EXACT_MODELS = {
    "ivfflat": ("IVFFLAT", {"ncentroids": 32}),
    "ivfflat_gather": ("IVFFLAT", {"ncentroids": 32,
                                   "scan_impl": "gather"}),
    "flat": ("FLAT", {}),
}


@pytest.mark.parametrize("cfg", sorted(EXACT_MODELS))
def test_port_engine_exact_models_recipe_dump_load(tmp_path, cfg):
    """The IVFFLAT and FLAT rows of the lifecycle matrix
    (tests/test_engine_e2e.py) through the verify recipe on the port; a
    fresh engine loads the dump and answers identically."""
    model, params = EXACT_MODELS[cfg]
    pkg = gamma_tpu_torch
    x = _corpus()
    eng = _engine(pkg, tmp_path, model, params)
    _recipe(pkg, eng, x)
    m = eng.vm.index_for("emb")
    assert m.model_name == model
    st = eng.engine_status()
    assert st.doc_count == N - 1
    assert st.min_indexed_num >= (0 if model == "FLAT" else N)
    # an update moves the doc to its new vector
    assert eng.add_or_update_doc(pkg.Doc(
        key="k7", fields={"price": 7.0, "tag": "t2"},
        vectors={"emb": x[8] + 0.01})) == 0
    eng.flush()
    ids, _ = _top(_search(pkg, eng, x[8:9]), 2)
    assert set(ids[0]) == {7, 8}
    before = _top(_search(pkg, eng, x[:50]))
    assert eng.dump() == 0
    eng.close()
    eng2 = _open(pkg, tmp_path)
    assert eng2.load() == 0
    after = _top(_search(pkg, eng2, x[:50]))
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])
    assert eng2.get_doc_by_key("k3") is None
    eng2.close()


@pytest.mark.parametrize("cfg", ["ivfflat", "flat"])
def test_port_loads_jax_legacy_dump_exact_models(tmp_path, jax_tpu_path,
                                                 cfg):
    """A JAX engine's dump of IVFFLAT / FLAT loads into the port's
    engine, which answers like it: same top-1, same sorted distances
    (1e-3: both scan bf16 rows with the query rounded to bf16)."""
    model, params = EXACT_MODELS[cfg]
    x = _corpus()
    jeng = _engine(gamma_tpu, tmp_path, model, params,
                   native_persistence=False)
    _recipe(gamma_tpu, jeng, x)
    assert jeng.dump() == 0
    teng = _open(gamma_tpu_torch, tmp_path, native_persistence=False)
    assert teng.load() == 0
    q = x[:200]
    jids, jd = _top(_search(gamma_tpu, jeng, q))
    tids, td = _top(_search(gamma_tpu_torch, teng, q))
    np.testing.assert_array_equal(tids[:, 0], jids[:, 0])
    live = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), live)
    np.testing.assert_allclose(np.sort(td, 1)[live], np.sort(jd, 1)[live],
                               rtol=1e-3, atol=2e-3)
    assert teng.get_doc_by_key("k3") is None and 3 not in tids
    jeng.close()
    teng.close()


def _engine_field(pkg, path, model, params, store_type="MemoryOnly",
                  store_param=None, **cfg):
    """_engine with the vector field's store type and parameters."""
    eng = _open(pkg, path, **cfg)
    dt = pkg.config.DataType
    eng.create_table(pkg.TableInfo(
        name="t",
        fields=[pkg.FieldInfo("price", dt.FLOAT, is_index=True),
                pkg.FieldInfo("tag", dt.STRING, is_index=True)],
        vectors=[pkg.VectorInfo("emb", D, store_type=store_type,
                                store_param=dict(store_param or {}))],
        indexing_size=1000, retrieval_types=[model],
        retrieval_params=[params]))
    return eng


def _dump_load_identical(pkg, eng, path, q):
    """A fresh engine loads the dump and answers `q` identically."""
    before = _top(_search(pkg, eng, q))
    assert eng.dump() == 0
    eng.close()
    eng2 = _open(pkg, path)
    assert eng2.load() == 0
    after = _top(_search(pkg, eng2, q))
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])
    return eng2


# the disk tier: (params, store_param)
DISK_MODELS = {
    "ivfpq_sq8": (PARAMS, {}),
    "ivfpq_pq_f16": (dict(PARAMS, gather_payload="pq"),
                     {"host_dtype": "float16"}),
    "fastscan": (dict(PARAMS, nsubvector=16), {}),
}


@pytest.mark.parametrize("cfg", sorted(DISK_MODELS))
def test_port_engine_disk_tier_recipe_dump_load(tmp_path, cfg):
    """The recipe on a RocksDB vector field: no device mirror anywhere,
    searches before training stream the host rows (exact), the rerank
    reads host rows through the LRU, and a fresh engine loads the dump
    and answers identically."""
    params, store_param = DISK_MODELS[cfg]
    model = "IVFPQ_FASTSCAN" if cfg == "fastscan" else "IVFPQ"
    pkg = gamma_tpu_torch
    x = _corpus()
    eng = _engine_field(pkg, tmp_path, model, params, "RocksDB",
                        store_param)
    store = eng.vm.stores["emb"]
    assert store.tier == "disk"
    # below indexing_size: exact search over the streamed host rows
    _ingest(pkg, eng, x[:500])
    xs = x[:500].astype(store.host_dtype).astype(np.float32)
    ids, _ = _top(_search(pkg, eng, x[:20]), 1)
    d2 = ((x[:20, None, :] - xs[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(ids[:, 0], np.argmin(d2, 1))
    eng.close()
    eng = _engine_field(pkg, tmp_path / "full", model, params, "RocksDB",
                        store_param)
    _recipe(pkg, eng, x)
    store, m = eng.vm.stores["emb"], eng.vm.index_for("emb")
    assert store.device.shape[0] == 8 and m.recon.shape[0] == 8
    assert m.scan_mode(pkg.config.SearchParams()) == "gather"
    assert store.cache_mem_bytes() <= 64 << 20
    eng2 = _dump_load_identical(pkg, eng, tmp_path / "full", x[:50])
    assert eng2.get_doc_by_key("k3") is None
    eng2.close()


def test_port_engine_scann_recipe_dump_load(tmp_path):
    """SCANN through the public API, inner product: rank 1 is the exact
    MIPS argmax, hybrid filters hold, a deleted doc vanishes, dense and
    gather agree on the top-1, and a fresh engine loads the dump (the
    mirror rebuilt from the anisotropic codes) and answers identically."""
    pkg = gamma_tpu_torch
    x = _corpus()
    eng = _engine(pkg, tmp_path, "SCANN",
                  {"ncentroids": 32, "nsubvector": 8, "nprobe": 16,
                   "metric_type": "InnerProduct"})
    _ingest(pkg, eng, x)
    m = eng.vm.index_for("emb")
    assert type(m).__name__ == "ScaNNIndex" and m.scan_mode(
        pkg.config.SearchParams()) == "dense"
    q = x[:100] + 0.05
    gt1 = np.argmax(q @ x.T, 1)
    for mode in ("dense", "gather"):
        ids, sc = _top(_search(pkg, eng, q, retrieval_params={
            "scan_mode": mode, "recall_num": 256}))
        assert np.mean(ids[:, 0] == gt1) >= 0.99, mode
        assert (np.diff(sc, axis=1) <= 1e-6).all()     # IP: largest first
    res = _search(pkg, eng, q[:30], fields=["price", "tag"],
                  range_filters=[pkg.RangeFilter("price", 100.0, 300.0)],
                  term_filters=[pkg.TermFilter("tag", "t1")])
    hits = [it for sr in res for it in sr.result_items]
    assert hits and all(100 <= it.attributes["price"] <= 300
                        and it.attributes["tag"] == "t1" for it in hits)
    victim = int(gt1[0])
    assert eng.delete(f"k{victim}") == 0
    ids, _ = _top(_search(pkg, eng, q[:1]))
    assert victim not in ids
    eng2 = _dump_load_identical(pkg, eng, tmp_path, q[:50])
    eng2.close()


def test_port_engine_binary_ivf_recipe_dump_load(tmp_path):
    """BINARYIVF through the public API: a stored row finds itself at
    Hamming distance 0, each score is the Hamming distance of its doc's
    sign bits, hybrid filters hold, a deleted doc vanishes, and a fresh
    engine loads the dump and answers identically."""
    pkg = gamma_tpu_torch
    x = _corpus()
    eng = _engine(pkg, tmp_path, "BINARYIVF", {"ncentroids": 16})
    _ingest(pkg, eng, x)
    rp = {"retrieval_params": {"nprobe": 8}}
    ids, sc = _top(_search(pkg, eng, x[:50], **rp))
    assert (sc[:, 0] == 0).all()
    bits = x > 0
    for i in range(50):
        np.testing.assert_array_equal(
            sc[i], (bits[ids[i]] != bits[i]).sum(1))
    res = _search(pkg, eng, x[:30], fields=["price"],
                  range_filters=[pkg.RangeFilter("price", 100.0, 300.0)],
                  **rp)
    hits = [it for sr in res for it in sr.result_items]
    assert hits and all(100 <= it.attributes["price"] <= 300
                        for it in hits)
    assert eng.delete("k3") == 0
    ids, _ = _top(_search(pkg, eng, x[3:4], k=100, **rp), 100)
    assert 3 not in ids
    eng2 = _dump_load_identical(pkg, eng, tmp_path, x[:50])
    eng2.close()


@pytest.mark.parametrize("model", ["SCANN", "BINARYIVF"])
def test_port_loads_jax_legacy_dump_new_models(tmp_path, jax_tpu_path,
                                               model):
    """A JAX engine's `.scann.npz` / `.bivf.npz` dump loads into the
    port's engine, which answers like it: SCANN the same top-1 and sorted
    (reranked) scores to 1e-3, BINARYIVF equal Hamming distances."""
    params = ({"ncentroids": 32, "nsubvector": 8, "nprobe": 16,
               "metric_type": "InnerProduct"} if model == "SCANN"
              else {"ncentroids": 16})
    rp = ({"scan_mode": "gather", "recall_num": 128} if model == "SCANN"
          else {"nprobe": 8})
    x = _corpus()
    jeng = _engine(gamma_tpu, tmp_path, model, params,
                   native_persistence=False)
    _ingest(gamma_tpu, jeng, x)
    assert jeng.delete("k3") == 0
    assert jeng.dump() == 0
    suffix = ".scann.npz" if model == "SCANN" else ".bivf.npz"
    assert any(f.endswith(suffix) for _, _, fs in os.walk(tmp_path)
               for f in fs)
    teng = _open(gamma_tpu_torch, tmp_path, native_persistence=False)
    assert teng.load() == 0
    q = x[:100] + 0.05
    jids, jd = _top(_search(gamma_tpu, jeng, q, retrieval_params=rp))
    tids, td = _top(_search(gamma_tpu_torch, teng, q, retrieval_params=rp))
    if model == "SCANN":
        np.testing.assert_array_equal(tids[:, 0], jids[:, 0])
        np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1),
                                   rtol=1e-3, atol=1e-3)
    else:
        np.testing.assert_array_equal(np.sort(td, 1), np.sort(jd, 1))
    assert teng.get_doc_by_key("k3") is None and 3 not in tids
    jeng.close()
    teng.close()
