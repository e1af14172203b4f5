"""The port's HNSW model (gamma_tpu_torch/index/hnsw.py) against the JAX
package's, function by function and as a whole.

Same numpy-seeded inputs through both packages (a local rng per test):
the tiled exact kNN self-join `_build_knn` (distances of the chosen ids
within rtol 1e-5: `torch.topk` does not order ties), the clustered
build's `_assign_top2`, `_group_members` and `_cluster_pass`,
`_merge_dedup`, `_patch_reverse` (with colliding writes: the JAX
scatter keeps the last, largest id) and `_alpha_prune` exactly,
`_beam_search` (distances within 1e-4, ids agreeing >= 0.99), whole
bulk, clustered (JAX's centroids injected) and incremental builds
(reverse and long-range columns equal, out-link distances within
1e-5), searches with a penalty and a realtime tail, the pump's
termination, and `.hnsw.npz` dumps loading across both packages.

Tests that change BUILD_CHUNK, a global the JAX package reads inside a
jitted function, clear JAX's trace caches before and after, so no trace
made under the patched value serves another test."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gamma_tpu.index.hnsw as jh
import gamma_tpu_torch.index.hnsw as th
from gamma_tpu.config import SearchParams as JSP
from gamma_tpu.ops import kmeans as jkm
from gamma_tpu.vector.raw_store import RawVectorStore as JStore
from gamma_tpu_torch.config import SearchParams
from gamma_tpu_torch.index import create_model, model_names
from gamma_tpu_torch.vector.raw_store import RawVectorStore

BIG = 3.0e38


@pytest.fixture
def fresh_jax():
    jax.clear_caches()
    yield
    jax.clear_caches()


def _normal(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _blobs(seed, n, d, n_clusters=16, scale=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    return (centers[rng.integers(0, n_clusters, n)]
            + scale * rng.normal(size=(n, d))).astype(np.float32)


def _stores(x):
    js = JStore("vec", x.shape[1])
    ts = RawVectorStore("vec", x.shape[1], device="cpu")
    for s in (js, ts):
        s.add(x)
        s.flush_device()
    return js, ts


def _models(x, params, add=True):
    js, ts = _stores(x)
    jm = jh.HNSWIndex(js, dict(params))
    tm = th.HNSWIndex(ts, dict(params))
    if add:
        ids = np.arange(x.shape[0], dtype=np.int64)
        jm.add(x, ids, ids)
        tm.add(x, ids, ids)
    return jm, tm


def _stored(js, n):
    """The rows as both mirrors hold them (bf16), in float64."""
    return np.asarray(js.device[:n], np.float32).astype(np.float64)


def _link_dists(rows, src, links, metric="l2"):
    """Distances of each row's links (-1: +inf), sorted per row."""
    safe = np.maximum(links, 0)
    if metric == "ip":
        d = -np.einsum("nd,nkd->nk", rows[src], rows[safe])
    else:
        d = ((rows[src][:, None, :] - rows[safe]) ** 2).sum(-1)
    return np.sort(np.where(links >= 0, d, np.inf), 1)


def _assert_out_links_match(js, jl, tl, r, rows_idx, metric="l2"):
    rows = _stored(js, js.n)
    jd = _link_dists(rows, rows_idx, jl[rows_idx, :r], metric)
    td = _link_dists(rows, rows_idx, tl[rows_idx, :r], metric)
    np.testing.assert_array_equal(np.isinf(jd), np.isinf(td))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-6)


def test_registered():
    assert "HNSW" in model_names()
    m = create_model("HNSW", RawVectorStore("v", 8, device="cpu"),
                     {"nlinks": 8})
    assert isinstance(m, th.HNSWIndex)
    assert m.links.shape == (th.NODE_PAD, 8 + 4 + 4)


@pytest.mark.parametrize("metric,chunk,inner,row0", [
    ("l2", 256, 512, 0), ("ip", 256, 512, 0), ("l2", 256, 512, 512),
    ("l2", 512, 4096, 0)])           # ic > 2048: JAX's approx_min_k path
def test_build_knn_matches_jax(monkeypatch, fresh_jax, metric, chunk,
                               inner, row0):
    x = _normal(1, 1100, 16)
    for mod in (jh, th):
        monkeypatch.setattr(mod, "BUILD_CHUNK", chunk)
        monkeypatch.setattr(mod, "INNER_CHUNK", inner)
    jm, tm = _models(x, {"nlinks": 12}, add=False)
    end, r = x.shape[0], 12
    jx, jn, jp, n_pad, ic = jm._padded_corpus(end)
    tx, tn, tp, t_pad, t_ic = tm._padded_corpus(end)
    assert (n_pad, ic) == (t_pad, t_ic)
    np.testing.assert_array_equal(np.asarray(jx, np.float32),
                                  tx.float().numpy())
    n_chunks = -(-(end - row0) // chunk)
    kw = dict(r=r, metric=metric, n_chunks=n_chunks, n_inner=n_pad // ic,
              ic=ic)
    jl = np.asarray(jh._build_knn(jx, jn, jp, jnp.int32(row0), **kw))
    tl = th._build_knn(tx, tn, tp, row0, **kw)
    assert tl.dtype == torch.int32 and tl.shape == jl.shape
    tl = tl.numpy()
    src = np.arange(row0, row0 + jl.shape[0])
    live = src < end
    rows = _stored(jm.store, end)
    jd = _link_dists(rows, src[live], jl[live], metric)
    td = _link_dists(rows, src[live], tl[live], metric)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    assert not (tl[live] == src[live][:, None]).any()      # no self-loops


def _centroids(seed, ncl, d):
    return np.random.default_rng(seed).normal(size=(ncl, d)).astype(
        np.float32)


def test_assign_top2_and_group_members_match_jax():
    x = _normal(2, 1024, 16)
    cents = _centroids(3, 24, 16)
    ja = np.asarray(jh._assign_top2(jnp.asarray(x), jnp.asarray(cents),
                                    jnp.sum(jnp.asarray(cents) ** 2, 1),
                                    chunk=256))
    ta = th._assign_top2(torch.from_numpy(x), torch.from_numpy(cents),
                         torch.from_numpy((cents ** 2).sum(1)), chunk=256)
    np.testing.assert_array_equal(ta.numpy(), ja)
    valid = np.arange(1024) < 1000
    for pi in range(2):
        for capm in (128, 40):           # 40 drops the rows past a cap
            jmem = np.asarray(jh._group_members(
                jnp.asarray(ja[:, pi]), jnp.asarray(valid), ncl=24,
                capm=capm))
            tmem = th._group_members(ta[:, pi], torch.from_numpy(valid),
                                     ncl=24, capm=capm)
            assert tmem.dtype == torch.int32
            np.testing.assert_array_equal(tmem.numpy(), jmem)
    assert (jmem >= 0).sum() < 1000                  # some were dropped


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cluster_pass_matches_jax(metric):
    x = _blobs(4, 1024, 16, n_clusters=8)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    norms = (xb.float() ** 2).sum(1)
    cents = _centroids(5, 12, 16)
    assign = np.asarray(jh._assign_top2(
        xj, jnp.asarray(cents), jnp.sum(jnp.asarray(cents) ** 2, 1),
        chunk=1024))
    members = jh._group_members(jnp.asarray(assign[:, 0]),
                                jnp.arange(1024) < 1000, ncl=12, capm=128)
    jv, ji = (np.asarray(a) for a in jh._cluster_pass(
        xj, jnp.asarray(norms.numpy()), members, r=8, metric=metric,
        ncl=12))
    tv, ti = th._cluster_pass(xb, norms, torch.from_numpy(
        np.array(members)), r=8, metric=metric, ncl=12)
    assert ti.dtype == torch.int32
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(tv >= BIG, jv >= BIG)
    np.testing.assert_array_equal(ti < 0, ji < 0)
    fin = jv < BIG
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=1e-5, atol=1e-5)
    rows = xb.double().numpy()
    src = np.flatnonzero((ji >= 0).any(1))
    np.testing.assert_allclose(
        _link_dists(rows, src, ti[src], metric),
        _link_dists(rows, src, ji[src], metric), rtol=1e-5, atol=1e-5)


def test_merge_dedup_matches_jax():
    rng = np.random.default_rng(6)
    n, w, r = 200, 9, 8
    v1 = np.sort(rng.random((n, w), np.float32), 1)
    v2 = np.sort(rng.random((n, w), np.float32), 1)
    i1 = rng.integers(-1, 40, (n, w)).astype(np.int32)
    i2 = rng.integers(-1, 40, (n, w)).astype(np.int32)
    # a duplicated id carries the same distance in both sets
    dup = rng.random((n, w)) < 0.3
    i2[dup], v2[dup] = i1[dup], v1[dup]
    v1[i1 < 0] = BIG
    ji, jv = (np.asarray(a) for a in jh._merge_dedup(
        jnp.asarray(v1), jnp.asarray(i1), jnp.asarray(v2),
        jnp.asarray(i2), r=r))
    ti, tv = th._merge_dedup(*(torch.from_numpy(a)
                               for a in (v1, i1, v2, i2)), r=r)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy(), jv)


def test_patch_reverse_matches_jax_on_collisions():
    """New ids of one residue mod n_reverse share a reverse column, so
    two of them listing the same out-neighbour write one (dst, col)
    slot: the JAX scatter, applied in order, leaves the later, larger
    id, and so must the port, whatever the device."""
    rng = np.random.default_rng(7)
    n, width, r, n_rev = 300, 20, 8, 8
    links = rng.integers(-1, n, (n, width)).astype(np.int32)
    new_ids = np.arange(200, 300, dtype=np.int32)
    new_out = rng.integers(-1, 40, (100, r)).astype(np.int32)
    slots = (r + new_ids % n_rev).astype(np.int32)
    pairs = {}
    for i, row in zip(new_ids, new_out):
        for dst in row[row >= 0]:
            pairs.setdefault((int(dst), int(r + i % n_rev)), []).append(i)
    assert sum(len(v) > 1 for v in pairs.values()) > 20      # collisions
    jl = np.asarray(jh._patch_reverse(jnp.asarray(links),
                                      jnp.asarray(new_ids),
                                      jnp.asarray(new_out),
                                      jnp.asarray(slots)))
    for (dst, col), writers in pairs.items():
        assert jl[dst, col] == max(writers)
    tin = torch.from_numpy(links.copy())
    tl = th._patch_reverse(tin, torch.from_numpy(new_ids),
                           torch.from_numpy(new_out),
                           torch.from_numpy(slots))
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tin.numpy(), links)    # not written


@pytest.mark.parametrize("prune_bytes", [1 << 29, 4096 * 16])
def test_alpha_prune_matches_jax(monkeypatch, prune_bytes):
    """Inputs far from any near-tie: neighbour rows spread apart and the
    node distances drawn away from every alpha^2 * d2(i, j)."""
    monkeypatch.setattr(th, "PRUNE_BYTES", prune_bytes)
    rng = np.random.default_rng(8)
    n, r, d = 300, 16, 8
    vecs = (rng.normal(size=(n, r, d)) * 2).astype(np.float32)
    ids = rng.integers(0, 10_000, (n, r)).astype(np.int32)
    ids[rng.random((n, r)) < 0.1] = -1
    dists = np.sort(rng.random((n, r)).astype(np.float32) * 60, 1)
    diff = vecs[:, :, None, :] - vecs[:, None, :, :]
    dnn = (diff.astype(np.float64) ** 2).sum(-1) * 1.44
    gap = np.abs(dnn - dists[:, None, :].astype(np.float64)).min()
    assert gap > 1e-4          # f32 rounds these sums by ~1e-5
    want = np.asarray(jh._alpha_prune(jnp.asarray(vecs), jnp.asarray(ids),
                                      jnp.asarray(dists), alpha=1.2))
    got = th._alpha_prune(torch.from_numpy(vecs), torch.from_numpy(ids),
                          torch.from_numpy(dists), alpha=1.2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).sum() > (ids < 0).sum()            # some pruned


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_beam_search_matches_jax(metric):
    x = _blobs(9, 3000, 24)
    jm, _ = _models(x, {"nlinks": 16})
    links = np.array(jm.links[: jm.n_nodes])
    rows = np.array(jm.store.device[:3000], np.float32)
    norms = np.array(jm.store.device_norms[:3000])
    q = (x[np.random.default_rng(10).choice(3000, 40, replace=False)]
         + 0.1 * _normal(11, 40, 24))
    pen = np.zeros(3000, np.float32)
    pen[::7] = BIG
    kw = dict(ef=48, k=10, iters=10, metric=metric, entry_stride=5,
              fanout=8)
    jd, ji = (np.asarray(a) for a in jh._beam_search(
        jnp.asarray(rows).astype(jnp.bfloat16), jnp.asarray(norms),
        jnp.asarray(links), jnp.asarray(q), jnp.asarray(pen), **kw))
    td, ti = th._beam_search(
        torch.from_numpy(rows).to(torch.bfloat16), torch.from_numpy(norms),
        torch.from_numpy(links), torch.from_numpy(q), torch.from_numpy(pen),
        **kw)
    td, ti = td.numpy(), ti.numpy()
    np.testing.assert_allclose(td, jd, atol=1e-4, rtol=1e-6)
    assert np.mean(ti == ji) >= 0.99
    assert (ti[ti >= 0] % 7 != 0).all()              # the penalty holds


def _assert_builds_match(jm, tm, rows_idx=None, metric="l2"):
    jl = np.asarray(jm.links[: jm.n_nodes])
    tl = tm.links[: tm.n_nodes].numpy()
    assert jm.n_nodes == tm.n_nodes and jl.shape == tl.shape
    r = jm.nlinks
    rows_idx = np.arange(jm.n_nodes) if rows_idx is None else rows_idx
    _assert_out_links_match(jm.store, jl, tl, r, rows_idx, metric)
    np.testing.assert_array_equal(tl[:, r:], jl[:, r:])   # reverse, long


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_bulk_build_matches_jax(metric):
    x = _normal(12, 1500, 16)
    jm, tm = _models(x, {"nlinks": 16, "metric_type": metric})
    assert tm.n_nodes == 1500
    _assert_builds_match(jm, tm, metric=metric.lower())
    assert tm.mem_bytes() == int(jm.links.size * 4)


def test_clustered_build_matches_jax(monkeypatch):
    """Past CLUSTER_BUILD_N the graph builds from two k-means partitions;
    the port's k-means draws another init from the same seed, so the
    JAX run's centroids are injected through `cents`."""
    for mod in (jh, th):
        monkeypatch.setattr(mod, "CLUSTER_BUILD_N", 500)
        monkeypatch.setattr(mod, "CLUSTER_TARGET", 256)
    seen = []
    jkmeans = jkm.kmeans

    def spy(*a, **kw):
        out = jkmeans(*a, **kw)
        seen.append(np.array(out[0]))
        return out

    monkeypatch.setattr(jkm, "kmeans", spy)
    x = _normal(13, 2000, 16)
    jm, tm = _models(x, {"nlinks": 16}, add=False)
    ids = np.arange(2000, dtype=np.int64)
    jm.add(x, ids, ids)
    assert len(seen) == 1 and seen[0].shape == (64, 16)
    monkeypatch.setattr(tm, "_clustered_knn", functools.partial(
        tm._clustered_knn, cents=torch.from_numpy(seen[0])))
    tm.add(x, ids, ids)
    _assert_builds_match(jm, tm)


def test_clustered_knn_draws_its_own_centroids(monkeypatch):
    """Without `cents` the port runs its own k-means from the same seed
    and still links every row to near neighbours."""
    monkeypatch.setattr(th, "CLUSTER_BUILD_N", 500)
    monkeypatch.setattr(th, "CLUSTER_TARGET", 256)
    x = _normal(14, 2000, 16)
    _, tm = _models(x, {"nlinks": 16})
    out = tm.links[:2000, :16].numpy()
    assert ((out >= 0).sum(1) >= 1).mean() > 0.98


def test_incremental_build_matches_jax(monkeypatch, fresh_jax):
    """Under test_hnsw.py's monkeypatches the growth step merges the new
    rows into the graph: both packages give the same graph, and the
    published links tensor of the port is never written."""
    for mod in (jh, th):
        monkeypatch.setattr(mod, "INCR_THRESHOLD", 64)
        monkeypatch.setattr(mod, "BUILD_CHUNK", 512)
    x = _normal(15, 2600, 24)
    n0 = 2000
    js, ts = _stores(x[:n0])
    jm = jh.HNSWIndex(js, {"nlinks": 12})
    tm = th.HNSWIndex(ts, {"nlinks": 12})
    ids = np.arange(n0, dtype=np.int64)
    for m in (jm, tm):
        m.add(x[:n0], ids, ids)
    published = tm.links
    before = published.clone()
    for s, m in ((js, jm), (ts, tm)):
        s.add(x[n0:])
        s.flush_device()
        vids = np.arange(n0, 2600, dtype=np.int64)
        m.add(x[n0:], vids, vids)
    assert tm.n_nodes == jm.n_nodes == 2600
    assert tm.links is not published
    assert torch.equal(published, before)
    row0 = (n0 // 512) * 512
    _assert_builds_match(jm, tm, rows_idx=np.arange(row0, 2600))
    np.testing.assert_array_equal(tm.links[:row0, :12].numpy(),
                                  before[:row0, :12].numpy())


def _search_both(jm, tm, q, pen, k=10, ef=64):
    jd, ji, _ = jm.search(jnp.asarray(q), jnp.asarray(pen),
                          JSP.from_dict({"efSearch": ef}), k)
    td, ti, tv = tm.search(torch.from_numpy(q), torch.from_numpy(pen),
                           SearchParams.from_dict({"efSearch": ef}), k)
    assert torch.equal(ti, tv)
    return np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()


def test_search_with_penalty_and_tail_matches_jax():
    """The same graph in both (the JAX build, loaded by the port), a
    penalty masking one row in three and a realtime tail below the
    1.25x rebuild step: equal distances, ids agreeing, the tail found."""
    x = _blobs(16, 1800, 16)
    jm, tm = _models(x[:1500], {"nlinks": 16}, add=True)
    tm._publish(links=torch.from_numpy(np.array(jm.links)),
                n_nodes=jm.n_nodes)
    for m in (jm, tm):
        m.store.add(x[1500:])
        m.store.flush_device()
        vids = np.arange(1500, 1800, dtype=np.int64)
        m.add(x[1500:], vids, vids)
    assert tm.n_nodes == jm.n_nodes == 1500                  # no rebuild
    pen = np.zeros(2048, np.float32)
    pen[::3] = BIG
    q = np.concatenate([x[1501:1540:3], x[:300:10]])
    jd, ji, td, ti = _search_both(jm, tm, q, pen)
    np.testing.assert_allclose(td, jd, atol=1e-4, rtol=1e-6)
    assert np.mean(ti == ji) >= 0.99
    np.testing.assert_array_equal(ti[:13, 0], np.arange(1501, 1540, 3))
    assert (ti[ti >= 0] % 3 != 0).all()


def test_flat_fallback_below_min_nodes_matches_jax():
    x = _normal(17, 200, 16)
    jm, tm = _models(x, {"nlinks": 16})
    assert tm.n_nodes == 200                  # built, but below 256 nodes
    pen = np.zeros(tm.store.device.shape[0], np.float32)
    jd, ji, td, ti = _search_both(jm, tm, x[:20], pen, k=5)
    np.testing.assert_allclose(td, jd, atol=1e-4, rtol=1e-6)
    np.testing.assert_array_equal(ti[:, 0], np.arange(20))


def test_pump_terminates_on_unflushed_rows():
    """test_hnsw.py's pump case on the port: rows ingested between
    flush_device() and the pump must not livelock the pump loop."""
    x = _normal(18, 600, 16)
    store = RawVectorStore("vec", 16, device="cpu")
    store.add(x[:500])
    store.flush_device()
    idx = th.HNSWIndex(store, {"nlinks": 8})
    store.add(x[500:])          # NOT flushed: the race window
    spins = 0
    while idx.indexed_count < store.n:
        start = idx.indexed_count
        end = min(start + 128, store.n)
        vids = np.arange(start, end, dtype=np.int64)
        idx.add(store.header(start, end), vids, vids)
        spins += 1
        assert spins < 100, "pump livelocked"
    assert idx.indexed_count == store.n
    store.flush_device()
    pen = torch.zeros(store.device.shape[0])
    _, ids, _ = idx.search(torch.from_numpy(x[550:551]), pen,
                           SearchParams.from_dict({}), 3)
    assert int(ids[0, 0]) == 550


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_dump_loads_across_packages(tmp_path, direction):
    x = _blobs(19, 1500, 16)
    jm, tm = _models(x, {"nlinks": 16})
    src, dst_pkg = (jm, th) if direction == "jax_to_torch" else (tm, jh)
    src.dump(str(tmp_path))
    dst = dst_pkg.HNSWIndex((tm if dst_pkg is th else jm).store,
                            {"nlinks": 16})
    assert dst.load(str(tmp_path)) == 1500
    assert dst.indexed_count == 1500
    np.testing.assert_array_equal(np.asarray(dst.links[:1500]),
                                  np.asarray(src.links[:1500]))
    if dst_pkg is th:
        jm, tm = src, dst
    else:
        jm, tm = dst, src
        tm._publish(links=torch.from_numpy(np.array(jm.links)),
                    n_nodes=jm.n_nodes)
    pen = np.zeros(2048, np.float32)
    jd, ji, td, ti = _search_both(jm, tm, x[:30], pen)
    np.testing.assert_allclose(td, jd, atol=1e-4, rtol=1e-6)
    assert np.mean(ti == ji) >= 0.99
    np.testing.assert_array_equal(ti[:, 0], np.arange(30))


def test_graph_quality_and_delete_tombstone():
    """The port's own build: no self-loops, no stranded node, recall@10
    against exact neighbours, and a tombstoned row never returned."""
    x = _blobs(20, 2000, 32, n_clusters=32, scale=0.15)
    _, tm = _models(x, {"nlinks": 16, "efSearch": 48})
    links = tm.links[:2000].numpy()
    assert not (links == np.arange(2000)[:, None]).any()
    indeg = np.bincount(links[links >= 0].ravel(), minlength=2000)
    assert (indeg == 0).sum() == 0
    sel = np.random.default_rng(21).choice(2000, 32, replace=False)
    pen = torch.zeros(2064)
    _, ids, _ = tm.search(torch.from_numpy(x[sel]), pen,
                          SearchParams.from_dict({"efSearch": 64}), 10)
    ids = ids.numpy()
    hits = sum(len(set(ids[i]) & set(np.argsort(
        ((x[q] - x) ** 2).sum(-1))[:10])) for i, q in enumerate(sel))
    assert hits / 320 >= 0.85
    assert (ids[:, 0] == sel).mean() >= 0.9
    pen[sel[0]] = BIG
    _, ids, _ = tm.search(torch.from_numpy(x[sel[:1]]), pen,
                          SearchParams(), 10)
    assert sel[0] not in ids.numpy()
