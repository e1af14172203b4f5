"""The disk tier of the port (store_type "RocksDB" / "Disk"): no device
mirror, a memmap host master read through a row-block LRU, gather-only
IVFPQ-family scans over the codes on the device, the exact rerank over
candidate rows fetched from the host, and brute-force search streaming
the host rows through the device.

Every case of tests/test_disk_tier.py is carried over with
device="cpu" (the wire round trip of SetConfig becomes the engine's
set_vector_cache_mb, the port having no wire surface yet), and the port
is held against the JAX package on the same seeded inputs:
flat_search_streaming (ids equal, distances to 1e-5 relative), disk-tier
IVFPQ searches over the SQ8 and the PQ payload after a cross-load of one
dump (the JAX side on its TPU code path with the kernels interpreted;
sorted distances to 1e-3, as tests/test_torch_ivfpq.py), a float16 host
store, and the SQ8 rerank guard on a disk store and a released mirror."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gamma_tpu_torch as T
from gamma_tpu.config import SearchParams as JSP
from gamma_tpu.index.ivfpq import IVFPQIndex as JIndex
from gamma_tpu.ops import flat_scan as jflat
from gamma_tpu.ops import pallas_adc as jadc
from gamma_tpu.ops import pallas_gadc as jgadc
from gamma_tpu.ops import pallas_gsq as jgsq
from gamma_tpu.vector.raw_store import RawVectorStore as JStore
from gamma_tpu_torch.config import SearchParams
from gamma_tpu_torch.index.ivfpq import IVFPQIndex
from gamma_tpu_torch.index.ivfpq_fastscan import IVFPQFastScanIndex
from gamma_tpu_torch.ops import flat_scan
from gamma_tpu_torch.vector.raw_store import RawVectorStore

from tests.conftest import make_blobs

D = 48


@pytest.fixture(scope="module")
def corpus():
    return make_blobs(np.random.default_rng(11), 6000, D, n_clusters=48)


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


def _gt(corpus, queries, k):
    d2 = (np.sum(queries**2, 1)[:, None] - 2 * queries @ corpus.T
          + np.sum(corpus**2, 1)[None, :])
    return np.argsort(d2, axis=1)[:, :k]


def _store(tmp_path, store_type="Disk", **kw):
    return RawVectorStore("v", D, store_type=store_type,
                          root_path=str(tmp_path), device="cpu", **kw)


def _search(idx, q, sp, k, pen_n=8192):
    d, docs, vids = idx.search(torch.from_numpy(np.asarray(q)),
                               torch.zeros(pen_n), SearchParams.from_dict(sp),
                               k)
    return d.numpy(), docs.numpy()


# ---- the cases of tests/test_disk_tier.py ----

@pytest.mark.parametrize("store_type", ["RocksDB", "Disk"])
def test_disk_store_has_no_mirror(tmp_path, corpus, store_type):
    s = _store(tmp_path, store_type)
    assert s.tier == "disk" and s.store_type == "Disk"
    s.add(corpus)
    assert s.flush_device() == 0
    assert s.device.shape[0] == 8         # placeholder only
    assert s.flushed == 0
    assert isinstance(s._host, np.memmap)  # the host master is a memmap
    np.testing.assert_allclose(s.get(np.array([5])), corpus[5:6],
                               rtol=1e-6)
    s.release_device()                    # a no-op on the disk tier
    assert not s.released and s.device.shape[0] == 8


def test_disk_ivfpq_recall(tmp_path, corpus):
    s = _store(tmp_path)
    s.add(corpus)
    idx = IVFPQIndex(s, {"ncentroids": 48, "nsubvector": 12, "nprobe": 12})
    assert not idx.keep_recon
    idx.train(corpus)
    ids = np.arange(corpus.shape[0], dtype=np.int64)
    idx.add(corpus, ids, ids)
    assert idx.recon.shape[0] == 8        # mirror never grew
    assert idx.scan_mode(SearchParams()) == "gather"
    rng = np.random.default_rng(5)
    queries = corpus[rng.choice(6000, 32, replace=False)]
    gt = _gt(corpus, queries, 10)
    _, docs = _search(idx, queries, {"recall_num": 100, "has_rank": True},
                      10)
    recall = np.mean([len(set(docs[i]) & set(gt[i])) / 10
                      for i in range(32)])
    assert recall >= 0.9, recall


def test_disk_fastscan_and_delete(tmp_path, corpus):
    s = _store(tmp_path)
    s.add(corpus)
    idx = IVFPQFastScanIndex(s, {"ncentroids": 48, "nsubvector": 24,
                                 "nprobe": 48})
    idx.train(corpus)
    ids = np.arange(corpus.shape[0], dtype=np.int64)
    idx.add(corpus, ids, ids)
    sp = {"recall_num": 100}
    _, docs = _search(idx, corpus[7:8], sp, 5)
    assert int(docs[0, 0]) == 7
    # the read-through rerank ranks by the true exact distance
    queries = corpus[16:32]
    gt = _gt(corpus, queries, 5)
    _, dr = _search(idx, queries, sp, 5)
    recall = np.mean([len(set(dr[i]) & set(gt[i])) / 5 for i in range(16)])
    assert recall >= 0.9, recall
    idx.delete(np.array([7]))
    _, docs2 = _search(idx, corpus[7:8], sp, 5)
    assert 7 not in docs2[0].tolist()


def test_disk_untrained_brute_streaming(tmp_path, corpus):
    s = _store(tmp_path)
    s.add(corpus)
    idx = IVFPQIndex(s, {"ncentroids": 48, "nsubvector": 12})
    queries = corpus[:8]
    gt = _gt(corpus, queries, 5)
    _, docs = _search(idx, queries, {}, 5)
    assert (docs == gt).all()


def _disk_engine(path, **cfg):
    eng = T.GammaEngine(T.EngineConfig(path=str(path), **cfg), device="cpu")
    eng.create_table(T.TableInfo(
        name="t",
        fields=[T.FieldInfo("price", T.config.DataType.FLOAT, True)],
        vectors=[T.VectorInfo("emb", D, store_type="RocksDB")],
        indexing_size=3000,
        retrieval_types=["IVFPQ"],
        retrieval_params=[{"ncentroids": 48, "nsubvector": 12,
                           "nprobe": 12}]))
    return eng


def test_engine_e2e_disk_tier(tmp_path, corpus):
    eng = _disk_engine(tmp_path / "eng")
    docs = [T.Doc(key=f"k{i}", fields={"price": float(i % 100)},
                  vectors={"emb": corpus[i]}) for i in range(6000)]
    for s0 in range(0, 6000, 1000):
        eng.add_or_update_docs(docs[s0:s0 + 1000])
    eng.build_index()
    eng.flush()
    store = eng.vm.stores["emb"]
    assert store.device.shape[0] == 8
    assert eng.vm.index_for("emb").recon.shape[0] == 8
    req = T.Request(topn=5, vec_fields=[T.VectorQuery("emb", corpus[3:4])])
    items = eng.search(req).results[0].result_items
    assert items and items[0].key == "k3"
    # deletes hold through the read-through path
    eng.delete("k3")
    assert all(it.key != "k3"
               for it in eng.search(req).results[0].result_items)
    # hybrid filter on every hit
    res = eng.search(T.Request(
        topn=10, vec_fields=[T.VectorQuery("emb", corpus[:16])],
        fields=["price"], range_filters=[T.RangeFilter("price", 10, 40)]))
    hits = [it for sr in res.results for it in sr.result_items]
    assert hits and all(10 <= it.attributes["price"] <= 40 for it in hits)
    # a brute-force request streams the host rows: exact over all 6000
    res = eng.search(T.Request(
        topn=5, brute_force_search=True,
        vec_fields=[T.VectorQuery("emb", corpus[100:108])]))
    gt = _gt(corpus, corpus[100:108], 5)
    got = np.array([[it.docid for it in sr.result_items]
                    for sr in res.results])
    np.testing.assert_array_equal(got, gt)
    # memory: the disk tier counts no host bytes and an 8-row mirror
    st = eng.engine_status()
    assert st.vector_mem_bytes == 8 * D * 2 + 8 * 4
    eng.close()


def test_row_block_lru(tmp_path, corpus):
    s = _store(tmp_path)
    s.add(corpus)
    cache = s._row_cache
    assert cache is not None
    vids = np.array([[0, 1, 4097], [5000, 4098, 2]])
    rows = s.get_padded(vids)
    assert rows.shape == (2, 3, D) and rows.dtype == np.float32
    np.testing.assert_allclose(rows[0, 0], corpus[0], rtol=1e-6)
    np.testing.assert_allclose(rows[1, 0], corpus[5000], rtol=1e-6)
    m0 = cache.misses
    s.get_padded(vids)                    # all blocks now resident
    assert cache.misses == m0 and cache.hits > 0
    # updates invalidate their block
    new_row = np.ones(D, np.float32)
    s.update(np.array([1]), new_row[None])
    np.testing.assert_allclose(s.get_padded(np.array([[1]]))[0, 0], new_row)
    # run-time resize (SetConfig semantics): shrink to about one block
    s.set_cache_bytes(4 * D * 4096)
    assert s.cache_mem_bytes() <= 4 * D * 4096
    # ids outside [0, n) clamp to a valid row, as the JAX store does
    js = JStore("v", D, store_type="Disk", root_path=str(tmp_path / "j"))
    js.add(s.header(0, s.n))
    odd = np.array([[-1, 0, 5999, 6000, 10 ** 6]])
    np.testing.assert_array_equal(s.get_padded(odd), js.get_padded(odd))


def test_cache_setconfig_roundtrip(tmp_path):
    """vector_cache_mb sizes every store's LRU at create_table, and
    set_vector_cache_mb resizes it at run time (the JAX test drives the
    same through the C API's SetConfig)."""
    eng = _disk_engine(tmp_path / "e3", vector_cache_mb=32)
    store = eng.vm.stores["emb"]
    assert store._row_cache._capacity == 32 << 20
    # two whole blocks are cached; the growing tail is read directly
    store.add(np.random.default_rng(0).normal(size=(9000, D)))
    store.get_padded(np.arange(9000))
    assert store.cache_mem_bytes() == 2 * 4096 * D * 4
    eng.set_vector_cache_mb(0)            # at least one block stays
    assert eng.config.vector_cache_mb == 0
    assert store._row_cache._capacity == 4096 * D * 4
    assert store.cache_mem_bytes() == 4096 * D * 4
    eng.set_vector_cache_mb(8)
    assert store._row_cache._capacity == 8 << 20
    eng.close()


@pytest.mark.parametrize("model", ["HNSW", "FLAT", "IVFFLAT", "BINARYIVF"])
def test_disk_rejects_mirror_dependent_models(tmp_path, model):
    eng = T.GammaEngine(T.EngineConfig(path=str(tmp_path / "eng2")),
                        device="cpu")
    with pytest.raises(ValueError, match="IVFPQ family"):
        eng.create_table(T.TableInfo(
            name="t2",
            fields=[T.FieldInfo("price", T.config.DataType.FLOAT, True)],
            vectors=[T.VectorInfo("emb", 16, store_type="Disk")],
            indexing_size=100,
            retrieval_types=[model],
            retrieval_params=[{}]))
    eng.close()


# ---- parity with the JAX package ----

@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n", [900, 5000])
def test_flat_search_streaming_matches_jax(corpus, metric, n):
    """The same host corpus, queries and penalty (every 7th row masked,
    rows past the penalty's end masked) through both streaming scans: at
    900 rows one 1024-row chunk, at 5000 two 4096-row chunks."""
    host = corpus[:n]
    rng = np.random.default_rng(3)
    q = (host[rng.choice(n, 12, replace=False)]
         + 0.05 * rng.normal(size=(12, D))).astype(np.float32)
    pen = np.zeros(n - 40, np.float32)
    pen[::7] = 3.0e38
    jd, ji = jflat.flat_search_streaming(host, n, jnp.asarray(q),
                                         jnp.asarray(pen), k=10,
                                         metric=metric)
    td, ti = flat_scan.flat_search_streaming(host, n, torch.from_numpy(q),
                                             torch.from_numpy(pen), k=10,
                                             metric=metric)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)
    assert (ti.numpy() % 7 != 0).all() and (ti.numpy() < n - 40).all()


def test_flat_search_streaming_score_range(corpus):
    host = corpus[:3000]
    q = host[:6] + 0.01
    d0, _ = flat_scan.flat_search_streaming(host, 3000, torch.from_numpy(q),
                                            torch.zeros(3000), k=10)
    # bounds off every distance (two packages' round-off must not decide)
    lo = float(d0[:, 2].min()) * (1 + 1e-3)
    hi = float(d0[:, 6].max()) * (1 - 1e-3)
    dr = torch.tensor([lo, hi])
    td, ti = flat_scan.flat_search_streaming(
        host, 3000, torch.from_numpy(q), torch.zeros(3000), dr, k=10)
    jd, ji = jflat.flat_search_streaming(
        host, 3000, jnp.asarray(q), jnp.zeros(3000), jnp.asarray(dr.numpy()),
        k=10)
    # masked slots (dist BIG) carry no id the callers read
    live = td.numpy() < 1e37
    np.testing.assert_array_equal(live, np.asarray(jd) < 1e37)
    np.testing.assert_array_equal(ti.numpy()[live], np.asarray(ji)[live])
    assert live.any() and ((td.numpy()[live] >= lo)
                           & (td.numpy()[live] <= hi)).all()


def _cross_loaded(tmp_path, corpus, params, host_dtype=np.float32):
    """A JAX disk-tier IVFPQ model trained and ingested, and the port's
    disk-tier model loaded from its dump, over the same host rows."""
    x = corpus[:4000]
    js = JStore("vec", D, store_type="Disk", root_path=str(tmp_path / "js"),
                host_dtype=host_dtype)
    ts = RawVectorStore("vec", D, store_type="Disk",
                        root_path=str(tmp_path / "ts"),
                        host_dtype=host_dtype, device="cpu")
    for s in (js, ts):
        s.add(x)
    jm = JIndex(js, params)
    jm.train(x[:3000])
    ids = np.arange(x.shape[0])
    jm.add(x, ids, ids)
    jm.dump(str(tmp_path / "dump"))
    tm = IVFPQIndex(ts, params)
    assert tm.load(str(tmp_path / "dump")) == x.shape[0]
    assert tm.recon.shape[0] == 8 and not tm.keep_recon
    return jm, tm, x


def _both(jm, tm, q, sp, k=10):
    jd, jdoc, _ = jm.search(jnp.asarray(q), jnp.zeros(8192, jnp.float32),
                            JSP.from_dict(sp), k, None,
                            validity_n=jm.indexed_count)
    td, tdoc, _ = tm.search(torch.from_numpy(q), torch.zeros(8192),
                            SearchParams.from_dict(sp), k, None,
                            validity_n=tm.indexed_count)
    return (np.asarray(jd), np.asarray(jdoc)), (td.numpy(), tdoc.numpy())


def _agree(a, b, rtol=1e-3):
    (da, ia), (db, ib) = a, b
    np.testing.assert_allclose(np.sort(db, 1), np.sort(da, 1), rtol=rtol,
                               atol=1e-3)
    overlap = np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(ia, ib)])
    assert overlap >= 0.95, overlap


@pytest.mark.parametrize("payload", ["sq8", "pq"])
def test_disk_ivfpq_matches_jax(tmp_path, corpus, jax_tpu_path, payload):
    """SQ8 payload: B1's scan, no rerank; PQ payload: B3's scan and the
    exact rerank of host-fetched rows."""
    params = {"ncentroids": 32, "nsubvector": 12, "nprobe": 16,
              "gather_payload": payload}
    jm, tm, x = _cross_loaded(tmp_path, corpus, params)
    assert tm.sq_active == (payload == "sq8")
    q = (x[np.random.default_rng(4).choice(4000, 24, replace=False)]
         + 0.02).astype(np.float32)
    sp = {"recall_num": 64, "has_rank": True}
    j, t = _both(jm, tm, q, sp)
    _agree(j, t)
    if payload == "pq":
        # reranked distances are exact to the host rows
        exact = ((q[:, None, :] - x[t[1]]) ** 2).sum(-1)
        np.testing.assert_allclose(t[0], exact, rtol=1e-4, atol=1e-3)
        # without the rerank the ADC distances come straight out
        _agree(*_both(jm, tm, q, dict(sp, has_rank=False)))


def test_disk_float16_host_end_to_end(tmp_path, corpus, jax_tpu_path):
    """host_dtype=float16: the memmap holds f16, get_padded hands back f32
    of the stored (rounded) values, the rerank is exact to them, both
    packages agree, and the store counts no host bytes."""
    params = {"ncentroids": 32, "nsubvector": 12, "nprobe": 16,
              "gather_payload": "pq"}
    jm, tm, x = _cross_loaded(tmp_path, corpus, params,
                              host_dtype=np.float16)
    ts = tm.store
    assert ts._host.dtype == np.float16
    x16 = x.astype(np.float16).astype(np.float32)
    got = ts.get_padded(np.arange(10)[None])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[0], x16[:10])
    assert ts.mem_bytes() == 8 * D * 2 + 8 * 4
    q = x[:16] + 0.01
    j, t = _both(jm, tm, q, {"recall_num": 64, "has_rank": True})
    _agree(j, t)
    exact = ((q[:, None, :] - x16[t[1]]) ** 2).sum(-1)
    np.testing.assert_allclose(t[0], exact, rtol=1e-4, atol=1e-3)


def _sq8_model(store, x):
    m = IVFPQIndex(store, {"ncentroids": 32, "nsubvector": 12, "nprobe": 16,
                           "scan_mode": "gather"})
    m.train(x)
    ids = np.arange(x.shape[0])
    m.add(x, ids, ids)
    return m


@pytest.mark.parametrize("where", ["disk", "released"])
def test_sq_rerank_needs_the_mirror(tmp_path, corpus, where):
    """sq_rerank asks the SQ8 scan for an exact rerank against the store
    mirror; without one (disk tier, released mirror) the search must not
    rerank against the placeholder's zero rows but answer as the plain
    SQ8 scan does."""
    x = corpus[:3000]
    store = _store(tmp_path, "Disk" if where == "disk" else "MemoryOnly")
    store.add(x)
    store.flush_device()
    m = _sq8_model(store, x)
    q = x[:16] + 0.01
    plain = _search(m, q, {"has_rank": True}, 10)
    if where == "released":
        rr = _search(m, q, {"has_rank": True, "sq_rerank": True,
                            "recall_num": 64}, 10)
        # with the mirror the rerank runs: exact distances to the rows
        exact = ((q[:, None, :] - x[rr[1]]) ** 2).sum(-1)
        np.testing.assert_allclose(rr[0], exact, rtol=2e-2, atol=2e-2)
        store.release_device()
        assert store.released and store.device.shape[0] == 8
    got = _search(m, q, {"has_rank": True, "sq_rerank": True,
                         "recall_num": 64}, 10)
    np.testing.assert_array_equal(got[1], plain[1])
    np.testing.assert_array_equal(got[0], plain[0])


def test_released_mirror_guards(tmp_path, corpus):
    """Over a released store mirror a dense scan raises, a PQ gather
    search with the rerank raises, and without the rerank it runs;
    flush_device() mirrors the rows again."""
    x = corpus[:3000]
    store = _store(tmp_path, "MemoryOnly")
    store.add(x)
    store.flush_device()
    m = IVFPQIndex(store, {"ncentroids": 32, "nsubvector": 12, "nprobe": 16,
                           "gather_payload": "pq"})
    m.train(x)
    ids = np.arange(x.shape[0])
    m.add(x, ids, ids)
    store.release_device()
    with pytest.raises(RuntimeError, match="released"):
        m.scan_mode(SearchParams.from_dict({"scan_mode": "dense"}))
    with pytest.raises(RuntimeError, match="released"):
        _search(m, x[:4], {"scan_mode": "gather", "has_rank": True}, 5)
    _, docs = _search(m, x[:4], {"scan_mode": "gather", "has_rank": False},
                      5)
    assert (docs >= 0).all()
    with pytest.raises(RuntimeError, match="device mirror"):
        m.build_sq_sidecar()
    assert store.flush_device() == x.shape[0] and not store.released
    _, docs = _search(m, x[:4], {"scan_mode": "dense"}, 5)
    assert (docs[:, 0] == np.arange(4)).all()
