"""Parity of the port's IVFPQ_FASTSCAN model (packed 4-bit codes, the
grouped ADC kernel B3 in packed form; the dense scan over its
reconstruction mirror; OPQ) with the JAX package's, through the shared
`.ivfpqfs.npz` dump format, with by_residual both ways and both
metrics.

A JAX model is trained and ingested; the port loads its dump and both
answer the same queries; the port's dump loads back into the JAX
package; further ingest, deletes and compaction leave both posting
states identical.  The JAX side searches on its TPU code path with the
kernel interpreted.  Exact ADC ties (docs sharing a code) may admit
different docs on each side, so searches compare the exact distances of
each side's chosen docs (ROADMAP rule)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.config import SearchParams as JSP
from gamma_tpu.index.ivfpq_fastscan import IVFPQFastScanIndex as JIndex
from gamma_tpu.ops import pallas_gadc as jgadc
from gamma_tpu.vector.raw_store import RawVectorStore as JStore
from gamma_tpu_torch.config import SearchParams as TSP
from gamma_tpu_torch.index import create_model
from gamma_tpu_torch.index.ivfpq_fastscan import IVFPQFastScanIndex as TIndex
from gamma_tpu_torch.ops import adc as tadc
from gamma_tpu_torch.vector.raw_store import RawVectorStore as TStore

D = 32
BASE = {"ncentroids": 16, "nsubvector": 16, "nprobe": 8,
        "scan_mode": "gather", "bucket_init_size": 64}
SP = {"recall_num": 300}


@pytest.fixture
def jax_tpu_path(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jgadc, "grouped_adc", functools.partial(
        jgadc.grouped_adc, interpret=True))


def _corpus(seed, n=3000):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(24, D)).astype(np.float32) * 2.0
    x = (centers[rng.integers(0, 24, n)]
         + 0.3 * rng.normal(size=(n, D))).astype(np.float32)
    q = (x[rng.choice(n, 20, replace=False)]
         + 0.1 * rng.normal(size=(20, D))).astype(np.float32)
    return x, q


def _store(cls, x):
    # the port's store lives on the card unless asked for the CPU
    s = cls("vec", D, device="cpu") if cls is TStore else cls("vec", D)
    s.add(x)
    s.flush_device()
    return s


def _search_j(m, q, k=10, sp=SP):
    pen = jnp.zeros(m.store.n + 64, jnp.float32)
    d, doc, _ = m.search(jnp.asarray(q), pen, JSP.from_dict(sp), k,
                         validity_n=m.indexed_count)
    return np.asarray(d), np.asarray(doc)


def _search_t(m, q, k=10, sp=SP):
    pen = torch.zeros(m.store.n + 64)
    d, doc, _ = m.search(torch.from_numpy(q), pen, TSP.from_dict(sp), k,
                         validity_n=m.indexed_count)
    return d.numpy(), doc.numpy()


def _exact(x, q, doc, metric):
    qq = q[:, None, :].astype(np.float64)
    p = x[np.maximum(doc, 0)].astype(np.float64)
    d = -(qq * p).sum(-1) if metric == "ip" else ((qq - p) ** 2).sum(-1)
    return np.where(doc >= 0, d, np.inf)


def _same_quality(x, q, a, b, metric):
    ea = np.sort(_exact(x, q, a[1], metric), 1)
    eb = np.sort(_exact(x, q, b[1], metric), 1)
    np.testing.assert_array_equal(np.isfinite(ea), np.isfinite(eb))
    ok = np.isfinite(ea)
    np.testing.assert_allclose(eb[ok], ea[ok], rtol=1e-3, atol=1e-3)


def _lists(state):
    lens = np.asarray(state.lens)
    docs = np.asarray(state.docids)
    return lens, [set(docs[i, :lens[i]].tolist()) - {-1}
                  for i in range(lens.size)]


@pytest.mark.parametrize("by_residual,metric", [
    (True, "l2"), (False, "l2"), (True, "ip"), (False, "ip")])
def test_fastscan_cross_load_search_ingest(tmp_path, jax_tpu_path,
                                           by_residual, metric):
    params = dict(BASE, by_residual=by_residual,
                  metric_type="InnerProduct" if metric == "ip" else "L2")
    x, q = _corpus(0)
    jm = JIndex(_store(JStore, x), params)
    jm.train(x[:2000])
    ids = np.arange(2500)
    jm.add(x[:2500], ids, ids)
    jm.dump(str(tmp_path / "j"))

    tm = TIndex(_store(TStore, x), params)
    assert tm.load(str(tmp_path / "j")) == 2500
    assert tuple(tm.state.codes.shape[::2]) == (16, 8)     # M/2 bytes
    assert not tm.sq_active and tm._cap_eff() == jm._cap_eff()
    xs = x[:2500]
    _same_quality(xs, q, _search_j(jm, q), _search_t(tm, q), metric)
    # without the rerank the ADC distances themselves agree
    a = _search_j(jm, q, sp={"has_rank": False})
    b = _search_t(tm, q, sp={"has_rank": False})
    scale = np.abs(a[0]).max()
    np.testing.assert_allclose(np.sort(b[0], 1), np.sort(a[0], 1),
                               rtol=1e-3, atol=1e-4 * scale)

    # port → JAX through <field>.ivfpqfs.npz
    tm.dump(str(tmp_path / "t"))
    with np.load(tmp_path / "t" / "vec.ivfpqfs.npz") as z:
        assert z["codes"].shape[-1] == 8
        assert not any(k.startswith("sq_") for k in z.files)
    jm2 = JIndex(_store(JStore, x), params)
    assert jm2.load(str(tmp_path / "t")) == 2500
    _same_quality(xs, q, _search_j(jm2, q), _search_t(tm, q), metric)

    # the same further ingest, deletes and compaction → the same lists
    more = np.arange(2500, 3000)
    jm.add(x[2500:], more, more)
    tm.add(x[2500:], more, more)
    np.testing.assert_array_equal(np.asarray(tm.state.codes),
                                  np.asarray(jm.state.codes))
    dead = np.random.default_rng(1).choice(3000, 1000, replace=False)
    for m in (jm, tm):
        m.delete(dead)
        m.compact()
    (jl, jsets), (tl, tsets) = _lists(jm.state), _lists(tm.state)
    np.testing.assert_array_equal(tl, jl)
    assert tsets == jsets and tl.sum() == 2000
    d, doc = _search_t(tm, q)
    assert not np.isin(doc[doc >= 0], dead).any()
    _same_quality(x, q, _search_j(jm, q), (d, doc), metric)


@pytest.mark.parametrize("by_residual", [True, False])
def test_fastscan_fresh_training_recall(by_residual):
    """The port training its own model (its own k-means draws) reaches
    the JAX package's recall@10 against exact search."""
    x, q = _corpus(2)
    params = dict(BASE, by_residual=by_residual)
    ids = np.arange(x.shape[0])
    jm, tm = JIndex(_store(JStore, x), params), TIndex(_store(TStore, x),
                                                       params)
    for m in (jm, tm):
        m.train(x)
        m.add(x, ids, ids)
    assert tm.p.nbits_per_idx == 4 and tm.pq.ksub == 16
    gt = np.argsort(_exact(x, q, np.tile(ids, (q.shape[0], 1)), "l2"),
                    1)[:, :10]

    def recall(doc):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(doc, gt)])

    r_t, r_j = recall(_search_t(tm, q)[1]), recall(_search_j(jm, q)[1])
    assert r_t >= 0.9 and r_t >= r_j - 0.03, (r_t, r_j)


def test_fastscan_b5_op_on_model_codes():
    """B5 (the per-query-LUT FastScan scan, no engine path) on the
    model's own packed codes equals the plain table scan over the
    unpacked codes (as tests/test_fastscan.py checks the TPU kernel)."""
    from gamma_tpu_torch.ops import ivf_scan, pq as tpq
    x, q = _corpus(3, n=1500)
    tm = TIndex(_store(TStore, x), BASE)
    tm.train(x)
    ids = np.arange(x.shape[0])
    tm.add(x, ids, ids)
    qt = torch.from_numpy(q)
    _, lids = ivf_scan.coarse_assign(qt, tm.centroids, tm.cent_norms, 8,
                                     "l2")
    lut = tpq.l2_lut(tm.pq, qt)
    got = tadc.adc_fs(tm.state.codes, lids, lut)
    ref = tpq.adc_scan(lut[:, None], tadc.unpack_nibbles(
        tm.state.codes[lids]))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_fastscan_params_and_registry():
    ts = TStore("vec", D, device="cpu")
    m = create_model("IVFPQ_FASTSCAN", ts, {"ncentroids": 16})
    assert isinstance(m, TIndex)
    assert m.p.nbits_per_idx == 4 and m.p.nsubvector == 64
    assert m.state.codes.shape[-1] == 32 and m.sq_payload == "pq"
    with pytest.raises(ValueError, match="even nsubvector"):
        TIndex(ts, dict(BASE, nsubvector=15))
    # OPQ constructs, trains and serves both scan modes
    x, q = _corpus(4, n=1200)
    ids = np.arange(x.shape[0])
    m = TIndex(_store(TStore, x), dict(BASE, has_opq=True))
    m.train(x)
    m.add(x, ids, ids)
    rot = m.opq_rot.numpy()
    np.testing.assert_allclose(rot.T @ rot, np.eye(D), atol=1e-4)
    for mode in ("dense", "gather"):
        d, doc = _search_t(m, q, sp=dict(SP, scan_mode=mode))
        assert np.isfinite(d).all() and (doc >= 0).all()


# ---- the dense scan's mirror and OPQ ----

DENSE = {k: v for k, v in BASE.items() if k != "scan_mode"}      # "auto"


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a).astype(jnp.float32)))


@pytest.mark.parametrize("by_residual,opq", [
    (True, False), (False, False), (True, True), (False, True)])
def test_fastscan_dense_mirror_and_search(tmp_path, jax_tpu_path,
                                          by_residual, opq):
    """A JAX FastScan model (with OPQ or not) dumps; the port rebuilds the
    mirror from the packed codes as the JAX model holds it, and dense
    and gather searches of both agree."""
    params = dict(DENSE, by_residual=by_residual, has_opq=opq)
    x, q = _corpus(5)
    jm = JIndex(_store(JStore, x), params)
    jm.train(x[:2000])
    ids = np.arange(3000)
    jm.add(x, ids, ids)
    jm.dump(str(tmp_path / "j"))
    tm = TIndex(_store(TStore, x), params)
    assert tm.load(str(tmp_path / "j")) == 3000
    assert (tm.opq_rot is not None) == opq
    assert tm.scan_mode(TSP()) == jm.scan_mode(JSP()) == "dense"
    a, b = _f32(tm.recon)[:3000], _f32(jm.recon)[:3000]
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    assert np.all(np.abs(a - b) <= ulp)
    np.testing.assert_allclose(_f32(tm.recon_norms)[:3000],
                               _f32(jm.recon_norms)[:3000], rtol=1e-5)
    # dense (the default) with the exact rerank: the same distances
    a, b = _search_j(jm, q), _search_t(tm, q)
    np.testing.assert_allclose(np.sort(b[0], 1), np.sort(a[0], 1),
                               rtol=1e-5, atol=1e-4)
    gather = dict(SP, scan_mode="gather")
    _same_quality(x, q, _search_j(jm, q, sp=gather),
                  _search_t(tm, q, sp=gather), "l2")
    # the port's own ingest on the carried quantizers decodes alike
    more = x[:200] + 0.01
    vids = np.arange(3000, 3200)
    jm.store.add(more)
    jm.store.flush_device()
    tm.store.add(more)
    tm.store.flush_device()
    jm.add(more, vids, vids)
    tm.add(more, vids, vids)
    a, b = _f32(tm.recon)[vids], _f32(jm.recon)[vids]
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    assert np.all(np.abs(a - b) <= ulp)


def test_refine_opq_fs_matches_jax_from_carried_state(monkeypatch):
    """_refine_opq_fs from the same rotated train set and codebooks: the
    same codebooks after two rounds (a later round may meet a near-tie
    that f32 summation order decides); the port keeps the product of the
    init rotation and each round's, the JAX package the last round's
    alone (ROADMAP.md C3)."""
    from gamma_tpu.ops import pq as jpq
    from gamma_tpu_torch.ops import pq as tpq

    def fixed(codebooks_of):
        def train(x, M, *, nbits=8, iters=12, seed=0):
            xs = np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                            np.float32)
            sel = np.linspace(0, xs.shape[0] - 1, 1 << nbits).astype(int)
            cb = xs[sel].reshape(1 << nbits, M, -1).transpose(1, 0, 2)
            return codebooks_of(np.ascontiguousarray(cb))
        return train

    monkeypatch.setattr(jpq, "train_pq", fixed(lambda cb: jpq.PQCodebooks(
        jnp.asarray(cb), jnp.asarray((cb * cb).sum(-1)))))
    monkeypatch.setattr(tpq, "train_pq", fixed(
        lambda cb: tpq.codebooks_from(torch.from_numpy(cb))))
    x, _ = _corpus(6, n=1500)
    params = dict(DENSE, by_residual=False, has_opq=True)
    jm = JIndex(JStore("vec", D), params)
    tm = TIndex(TStore("vec", D, device="cpu"), params)
    init = np.asarray(jm._train_opq_init(jnp.asarray(x)))
    xd = (x @ init).astype(np.float32)
    jm.opq_rot, tm.opq_rot = jnp.asarray(init), torch.tensor(init)
    jm.pq = jpq.train_pq(xd, 16, nbits=4)
    tm.pq = tpq.train_pq(torch.tensor(xd), 16, nbits=4)
    r = [np.asarray(init)]

    def svd_spy(fn):
        def spy(m, **kw):
            out = fn(m, **kw)
            r.append(np.asarray(out[0] @ out[2]))
            return out
        return spy

    with monkeypatch.context() as mp:
        mp.setattr(jnp.linalg, "svd", svd_spy(jnp.linalg.svd))
        jm._refine_opq_fs(jnp.asarray(xd), iters=2)
    tm._refine_opq_fs(torch.tensor(xd), iters=2)
    np.testing.assert_allclose(tm.pq.codebooks.numpy(),
                               np.asarray(jm.pq.codebooks), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(jm.opq_rot), r[-1], atol=1e-6)
    np.testing.assert_allclose(tm.opq_rot.numpy(), r[0] @ r[1] @ r[2],
                               rtol=1e-4, atol=1e-4)
