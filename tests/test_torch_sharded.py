"""Parity of the port's multi-device serving (gamma_tpu_torch/parallel and
the engine's sharded search) with the JAX package's.

The JAX side runs on the conftest's 8 virtual CPU devices with
build_mesh(4, 2) (or 8 x 1); the port's runs over the same layout with
devices=[cpu] * 8.  The models come from one JAX training: the port
loads its dump, so both sides hold the same lists, codebooks and rows.
Each test feeds the same numpy inputs, drawn from a local
np.random.default_rng(seed), through both, and holds the port's
sharded search against the JAX function and against its own
single-device search.

Tolerances: f32 distances after the exact rerank rtol 1e-4 (atol 1e-3:
near-zero self-distances carry the norm expansion's round-off); the SQ8
scan, whose query operand is rounded to bf16 in the port's kernel
wrapper and kept in f32 by the JAX "xla" body, rtol 1e-2 against JAX and
1e-4 against the port's own single-device scan.  torch and XLA break
ties differently, so ids are compared by agreement rates, as
tests/test_sharded.py does, and by the distances of the chosen ids."""

import functools
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_blobs

import gamma_tpu
import gamma_tpu_torch
from gamma_tpu import parallel as jpar
from gamma_tpu.index.ivfpq import IVFPQIndex as JIndex
from gamma_tpu.index.ivfpq_fastscan import IVFPQFastScanIndex as JFSIndex
from gamma_tpu.ops import pallas_gadc as jgadc
from gamma_tpu.ops import pallas_gsq as jgsq
from gamma_tpu.ops import kmeans as jkm
from gamma_tpu.ops.distances import pairwise_l2 as jpairwise_l2
from gamma_tpu.vector.raw_store import RawVectorStore as JStore
from gamma_tpu_torch import parallel as tpar
from gamma_tpu_torch.config import SearchParams as TSP
from gamma_tpu_torch.index.ivfpq import IVFPQIndex as TIndex
from gamma_tpu_torch.index.ivfpq_fastscan import (
    IVFPQFastScanIndex as TFSIndex)
from gamma_tpu_torch.ops import ivf_scan as tivf
from gamma_tpu_torch.ops import kmeans as tkm
from gamma_tpu_torch.ops.distances import BIG
from gamma_tpu_torch.parallel import sharded as tsh
from gamma_tpu_torch.vector.raw_store import RawVectorStore as TStore

CPU8 = [torch.device("cpu")] * 8
PARAMS = {"ncentroids": 64, "nsubvector": 8, "nprobe": 16}


@pytest.fixture(autouse=True)
def jax_kernels(monkeypatch):
    """The JAX bodies' TPU scans (scan_impl="pallas"), interpreted: they
    round the scan operands to bf16 as the port's kernel wrappers do."""
    monkeypatch.setattr(jgsq, "grouped_sq_scan", functools.partial(
        jgsq.grouped_sq_scan, interpret=True))
    monkeypatch.setattr(jgadc, "grouped_adc", functools.partial(
        jgadc.grouped_adc, interpret=True))


# the JAX search steps on their TPU scans (kernels interpreted above)
_jpq = functools.partial(jpar.sharded_ivfpq_search_fn, scan_impl="pallas")
_jsq = functools.partial(jpar.sharded_ivfsq_search_fn, scan_impl="pallas")


def _jmesh(l=4, q=2):
    return jpar.build_mesh(n_list_shards=l, n_query_shards=q)


def _tmesh(l=4, q=2):
    return tpar.build_mesh(l, q, CPU8)


def _np(*xs):
    return tuple(np.asarray(x) for x in xs)


def _stores(x, name="vec"):
    js, ts = JStore(name, x.shape[1]), TStore(name, x.shape[1],
                                             device="cpu")
    for s in (js, ts):
        s.add(x)
        s.flush_device()
    return js, ts


def _build(tmp, x, jcls, tcls, params, name="vec"):
    """A JAX model trained and filled with x, and the port's model
    loaded from its dump."""
    js, ts = _stores(x, name)
    jm = jcls(js, params)
    jm.train(x)
    ids = np.arange(x.shape[0], dtype=np.int64)
    jm.add(x, ids, ids)
    jm.dump(str(tmp))
    tm = tcls(ts, params)
    assert tm.load(str(tmp)) == x.shape[0]
    return jm, tm


@pytest.fixture(scope="module")
def corpus():
    return make_blobs(np.random.default_rng(3), 20000, 64, n_clusters=64)


@pytest.fixture(scope="module")
def built(corpus, tmp_path_factory):
    return _build(tmp_path_factory.mktemp("ivfpq"), corpus, JIndex, TIndex,
                  PARAMS)


def _queries(seed, n, d=64):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def _shard_pq(jm, tm, jmesh, tmesh):
    jsh = jpar.shard_ivfpq(jmesh, jm.state, jm.centroids, jm.cent_norms,
                           jm.pq, jm.store.device)
    tshd = tpar.shard_ivfpq(tmesh, tm.state, tm.centroids, tm.cent_norms,
                            tm.pq, tm.store.device)
    return jsh, tshd


def _single_t(tm, q, pen, nprobe, recall, k, **kw):
    return _np(*tivf.ivfpq_search(
        tm.state, tm.centroids, tm.cent_norms, tm.pq, torch.from_numpy(q),
        pen, tm.store.device, nprobe=nprobe, recall_num=recall, k=k, **kw))


# ---------------------------------------------------------------------
# IVFPQ over the PQ codes (B3 in the port), owner-computes rerank (X1)
# ---------------------------------------------------------------------

def test_sharded_matches_single_chip(built):
    jm, tm = built
    jsh, tshd = _shard_pq(jm, tm, _jmesh(), _tmesh())
    nprobe, recall, k = 16, 64, 10
    q = _queries(0, 16)
    n = tm.store.n + 64
    # local_probe = nprobe: provably the single-device candidate set
    jd, jdoc, _ = _np(*_jpq(
        _jmesh(), nprobe=nprobe, recall_num=recall, k=k, local_probe=nprobe,
        v_per_shard=jsh.v_per_shard)(jsh, jnp.asarray(q),
                                     jnp.zeros(n, jnp.float32)))
    fn = tpar.sharded_ivfpq_search_fn(
        _tmesh(), nprobe=nprobe, recall_num=recall, k=k, local_probe=nprobe,
        v_per_shard=tshd.v_per_shard)
    td, tdoc, tvid = _np(*fn(tshd, torch.from_numpy(q), torch.zeros(n)))
    rd, rdoc, rvid = _single_t(tm, q, torch.zeros(n), nprobe, recall, k)
    np.testing.assert_allclose(td, rd, rtol=1e-4, atol=1e-3)
    assert _agree(tdoc, rdoc) > 0.95 and _agree(tvid, rvid) > 0.95
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-3)
    assert _agree(tdoc, jdoc) > 0.95


def test_sharded_default_local_probe_recall(built):
    """The default (work-split) local_probe loses almost nothing."""
    jm, tm = built
    jsh, tshd = _shard_pq(jm, tm, _jmesh(8, 1), _tmesh(8, 1))
    q = _queries(1, 8)
    n = tm.store.n + 64
    jd, jdoc, _ = _np(*_jpq(
        _jmesh(8, 1), nprobe=16, recall_num=64, k=10,
        v_per_shard=jsh.v_per_shard)(jsh, jnp.asarray(q),
                                     jnp.zeros(n, jnp.float32)))
    fn = tpar.sharded_ivfpq_search_fn(_tmesh(8, 1), nprobe=16, recall_num=64,
                                      k=10, v_per_shard=tshd.v_per_shard)
    td, tdoc, _ = _np(*fn(tshd, torch.from_numpy(q), torch.zeros(n)))
    _, rdoc, _ = _single_t(tm, q, torch.zeros(n), 16, 64, 10)
    overlap = np.mean([len(set(tdoc[i]) & set(rdoc[i])) / 10
                       for i in range(8)])
    assert overlap >= 0.9, overlap
    # the same local_probe rule on both sides: the same answers
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-3)
    assert _agree(tdoc, jdoc) > 0.95


def test_sharded_respects_penalty(built):
    jm, tm = built
    jsh, tshd = _shard_pq(jm, tm, _jmesh(), _tmesh())
    pen = np.zeros(tm.store.n + 64, np.float32)
    pen[::2] = BIG   # mask all even docids
    q = _queries(2, 8)
    _, jdoc, _ = _np(*_jpq(
        _jmesh(), nprobe=16, recall_num=64, k=10, local_probe=16,
        v_per_shard=jsh.v_per_shard)(jsh, jnp.asarray(q), jnp.asarray(pen)))
    fn = tpar.sharded_ivfpq_search_fn(_tmesh(), nprobe=16, recall_num=64,
                                      k=10, local_probe=16,
                                      v_per_shard=tshd.v_per_shard)
    _, tdoc, _ = _np(*fn(tshd, torch.from_numpy(q), torch.from_numpy(pen)))
    for doc in (tdoc, jdoc):
        live = doc[doc >= 0]
        assert live.size and np.all(live % 2 == 1)
    assert _agree(tdoc, jdoc) > 0.95


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_sharded_ivfpq_metric_and_validity(built, metric):
    """Both metrics, the validity mask in place of the penalty (the last
    500 rows not live), with and without the rerank, against the port's
    single-device search and the JAX function."""
    jm, tm = built
    jsh, tshd = _shard_pq(jm, tm, _jmesh(), _tmesh())
    q = _queries(3, 16)
    n = tm.store.n + 64
    live_n = tm.store.n - 500          # the last 500 rows are not live
    common = dict(nprobe=16, recall_num=64, k=10, metric=metric,
                  local_probe=16, use_validity=True)
    for rerank in (True, False):
        jd, jdoc, _ = _np(*_jpq(
            _jmesh(), rerank=rerank, v_per_shard=jsh.v_per_shard,
            **common)(jsh, jnp.asarray(q), jnp.zeros(n, jnp.float32),
                      live_n=live_n))
        td, tdoc, _ = _np(*tpar.sharded_ivfpq_search_fn(
            _tmesh(), rerank=rerank, v_per_shard=tshd.v_per_shard,
            **common)(tshd, torch.from_numpy(q), torch.zeros(n),
                      live_n=live_n))
        rd, rdoc, _ = _single_t(tm, q, torch.zeros(n), 16, 64, 10,
                                metric=metric, rerank=rerank, live_n=live_n)
        assert np.all(tdoc < live_n) and np.all(jdoc < live_n)
        np.testing.assert_allclose(td, rd, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-3)
        if rerank:
            assert _agree(tdoc, rdoc) > 0.95 and _agree(tdoc, jdoc) > 0.95
        # without the rerank, codes of this tight corpus tie (equal
        # codes, equal distances) and the tie-breaks choose the ids: the
        # distances above hold the answer


def test_sharded_gather_rerank_opq_space(tmp_path):
    """With OPQ the exact rerank compares raw rows against the UNROTATED
    query; self-retrieval distance is then ~0 on both sides."""
    corpus = np.random.default_rng(4).normal(size=(4096, 32)).astype(
        np.float32)
    params = {"ncentroids": 32, "nsubvector": 8, "nprobe": 32,
              "has_opq": True}
    jm, tm = _build(tmp_path, corpus, JIndex, TIndex, params)
    jsh, tshd = _shard_pq(jm, tm, _jmesh(), _tmesh())
    q_raw = corpus[:8]
    n = tm.store.n + 64
    jd, jdoc, _ = _np(*_jpq(
        _jmesh(), nprobe=32, recall_num=64, k=5, local_probe=32,
        v_per_shard=jsh.v_per_shard)(jsh, jm._rotate(jnp.asarray(q_raw)),
                                     jnp.zeros(n, jnp.float32),
                                     jnp.asarray(q_raw)))
    qt = torch.from_numpy(q_raw)
    td, tdoc, _ = _np(*tpar.sharded_ivfpq_search_fn(
        _tmesh(), nprobe=32, recall_num=64, k=5, local_probe=32,
        v_per_shard=tshd.v_per_shard)(tshd, tm._rotate(qt), torch.zeros(n),
                                      qt))
    for d, doc in ((td, tdoc), (jd, jdoc)):
        assert list(doc[:, 0]) == list(range(8))
        # the rerank is in the raw space: self-distance ~0 (bf16 rows)
        assert np.all(d[:, 0] < 1e-2), d[:, 0]
    np.testing.assert_allclose(td[:, 0], jd[:, 0], rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------
# FastScan: packed 4-bit codes through the shard body's packed branch
# ---------------------------------------------------------------------

@pytest.mark.parametrize("by_residual,layout", [(True, (4, 2)),
                                                (False, (8, 1))])
def test_sharded_fastscan(corpus, tmp_path, by_residual, layout):
    """Residual (test_sharded_fastscan_matches_single) and raw-coded
    (test_sharded_fastscan_raw_coded) packed codes: the sharded search
    at local_probe = nprobe equals the single-device FastScan search and
    the JAX function.

    Raw-coded 4-bit codes of this corpus tie by the hundreds: 133 to 200
    of a query's 200 nearest codes share the 64th distance, so which of
    them fill the recall_num = 64 pool is the select's tie-break (torch
    orders no ties).  There the reranked answers are held to their own
    rows' exact distances, and the pools by their distances (the search
    without the rerank, whose distances are tie-proof and whose ids are
    not)."""
    params = dict(PARAMS, by_residual=by_residual)
    jm, tm = _build(tmp_path, corpus, JFSIndex, TFSIndex, params,
                    name="vecfs")
    assert tm.packed_codes and tm.state.codes.shape[-1] == 4  # M/2 bytes
    jsh, tshd = _shard_pq(jm, tm, _jmesh(*layout), _tmesh(*layout))
    q = _queries(5, 16)
    n = tm.store.n + 64
    common = dict(nprobe=16, recall_num=64, k=10, local_probe=16,
                  packed=True, by_residual=by_residual)
    qt = torch.from_numpy(q)
    for rerank in (True, False):
        jd, jdoc, _ = _np(*_jpq(
            _jmesh(*layout), v_per_shard=jsh.v_per_shard, rerank=rerank,
            **common)(jsh, jnp.asarray(q), jnp.zeros(n, jnp.float32)))
        td, tdoc, _ = _np(*tpar.sharded_ivfpq_search_fn(
            _tmesh(*layout), v_per_shard=tshd.v_per_shard, rerank=rerank,
            **common)(tshd, qt, torch.zeros(n)))
        rd, rdoc, _ = _np(*tivf.ivfpqfs_search(
            tm.state, tm.centroids, tm.cent_norms, tm.pq, qt,
            torch.zeros(n), tm.store.device, nprobe=16, recall_num=64, k=10,
            rerank=rerank, by_residual=by_residual))
        if rerank and not by_residual:
            xs = tm.store.device.float().numpy()
            exact = ((q[:, None, :] - xs[tdoc]) ** 2).sum(-1)
            np.testing.assert_allclose(td, exact, rtol=1e-4, atol=1e-3)
            continue
        np.testing.assert_allclose(td, rd, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-3)
        if rerank:
            assert _agree(tdoc, rdoc) > 0.95 and _agree(tdoc, jdoc) > 0.95


# ---------------------------------------------------------------------
# SQ8 capacity tier (B1 in the port): exact scan, one merge
# ---------------------------------------------------------------------

def _shard_sq(jm, tm, jmesh, tmesh):
    jsh = jpar.shard_ivfsq(jmesh, jm.state, jm.centroids, jm.cent_norms,
                           jm.sq_codes, jm.sq_norms, jm.sq_scale, jm.sq_off,
                           cap_eff=jm._cap_eff())
    tshd = tpar.shard_ivfsq(tmesh, tm.state, tm.centroids, tm.cent_norms,
                            tm.sq_codes, tm.sq_norms, tm.sq_scale,
                            tm.sq_off, cap_eff=tm._cap_eff())
    return jsh, tshd


def test_sharded_ivfsq_matches_single_chip(built):
    jm, tm = built
    assert tm.sq_active and tm._cap_eff() == jm._cap_eff()
    jsh, tshd = _shard_sq(jm, tm, _jmesh(), _tmesh())
    q = _queries(6, 16)
    n = tm.store.n + 64
    jd, jdoc, _ = _np(*_jsq(
        _jmesh(), nprobe=16, k=10, local_probe=16)(
            jsh, jnp.asarray(q), jnp.zeros(n, jnp.float32)))
    td, tdoc, _ = _np(*tpar.sharded_ivfsq_search_fn(
        _tmesh(), nprobe=16, k=10, local_probe=16)(
            tshd, torch.from_numpy(q), torch.zeros(n)))
    rd, rdoc, _ = _np(*tivf.ivfsq_search(
        tm.state, tm.sq_codes, tm.sq_norms, tm.sq_scale, tm.sq_off,
        tm.centroids, tm.cent_norms, torch.from_numpy(q), torch.zeros(n),
        nprobe=16, k=10, cap_eff=tm._cap_eff()))
    np.testing.assert_allclose(td, rd, rtol=1e-4, atol=1e-3)
    assert _agree(tdoc, rdoc) > 0.95
    np.testing.assert_allclose(td, jd, rtol=1e-2, atol=1e-2)
    assert _agree(tdoc, jdoc) > 0.9


def test_sharded_ivfsq_respects_penalty(built):
    jm, tm = built
    jsh, tshd = _shard_sq(jm, tm, _jmesh(8, 1), _tmesh(8, 1))
    pen = np.zeros(tm.store.n + 64, np.float32)
    pen[::2] = BIG
    q = _queries(7, 8)
    _, jdoc, _ = _np(*_jsq(
        _jmesh(8, 1), nprobe=16, k=10, local_probe=16)(
            jsh, jnp.asarray(q), jnp.asarray(pen)))
    _, tdoc, _ = _np(*tpar.sharded_ivfsq_search_fn(
        _tmesh(8, 1), nprobe=16, k=10, local_probe=16)(
            tshd, torch.from_numpy(q), torch.from_numpy(pen)))
    for doc in (tdoc, jdoc):
        live = doc[doc >= 0]
        assert live.size and np.all(live % 2 == 1)
    assert _agree(tdoc, jdoc) > 0.9


def test_sharded_ivfsq_validity_matches_penalty(built):
    """use_validity=True (no doc-space penalty gather) returns the same
    results as the zero-penalty path when nothing is deleted, on both
    sides."""
    jm, tm = built
    jsh, tshd = _shard_sq(jm, tm, _jmesh(), _tmesh())
    q = _queries(8, 16)
    n = tm.store.n + 64
    out = {}
    for side, make, mesh, sh, qq, pen in (
            ("jax", _jsq, _jmesh(), jsh, jnp.asarray(q), jnp.zeros(n)),
            ("port", tpar.sharded_ivfsq_search_fn, _tmesh(), tshd,
             torch.from_numpy(q), torch.zeros(n))):
        f_pen = make(mesh, nprobe=16, k=10, local_probe=16)
        f_val = make(mesh, nprobe=16, k=10, local_probe=16,
                     use_validity=True)
        pd, pdoc, _ = _np(*f_pen(sh, qq, pen))
        vd, vdoc, _ = _np(*f_val(sh, qq, pen, live_n=tm.store.n))
        np.testing.assert_allclose(pd, vd, rtol=1e-5, atol=1e-5)
        assert _agree(pdoc, vdoc) > 0.98
        out[side] = vd
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-2,
                               atol=1e-2)


# ---------------------------------------------------------------------
# dense scan over the row-sharded reconstruction mirror
# ---------------------------------------------------------------------

def test_sharded_dense_matches_single(built):
    """Row-sharded dense scan + owner-computes rerank == the port's
    single-device dense search, and the JAX function picks rows as close
    (top-1 distances recomputed on the host, rtol 1e-2: both rerank from
    the bf16 mirror)."""
    jm, tm = built
    jsd = jpar.shard_dense(_jmesh(), jm.recon, jm.recon_norms,
                           jm.recon_valid, jm.store.device)
    tsd = tpar.shard_dense(_tmesh(), tm.recon, tm.recon_norms,
                           tm.recon_valid, tm.store.device)
    assert tsd.rows_per_shard == jsd.rows_per_shard
    q = _queries(1234, 16)
    jd, jv = _np(*jpar.sharded_dense_search_fn(
        _jmesh(), recall_num=64, k=10, rows_per_shard=jsd.rows_per_shard)(
            jsd, jnp.asarray(q), jnp.zeros(jsd.recon.shape[0]),
            jnp.asarray(q)))
    qt = torch.from_numpy(q)
    td, tv = _np(*tpar.sharded_dense_search_fn(
        _tmesh(), recall_num=64, k=10, rows_per_shard=tsd.rows_per_shard)(
            tsd, qt, torch.zeros(tsd.recon.shape[0]), qt))
    rd, rdoc, _ = _np(*tm.search(
        qt, torch.zeros(tm.store.n + 64),
        TSP.from_dict({"scan_mode": "dense", "recall_num": 64}), 10))
    np.testing.assert_allclose(td, rd, rtol=1e-4, atol=1e-3)
    assert _agree(tv, rdoc) > 0.95
    xs = tm.store.header(0, tm.store.n).astype(np.float64)
    qh = q.astype(np.float64)
    d_t = np.sum((qh - xs[tv[:, 0]]) ** 2, axis=1)
    d_j = np.sum((qh - xs[jv[:, 0]]) ** 2, axis=1)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(td[:, 0], d_t, rtol=1e-2, atol=1e-2)
    overlap = np.mean([len(set(tv[i]) & set(jv[i])) / 10 for i in range(16)])
    assert overlap >= 0.9, overlap


# ---------------------------------------------------------------------
# brute force and k-means
# ---------------------------------------------------------------------

def test_sharded_flat_exact():
    corpus = make_blobs(np.random.default_rng(9), 2000, 32)
    n, d = corpus.shape
    s = 4
    v_pad = -(-n // s) * s
    raw = np.zeros((v_pad, d), np.float32)
    raw[:n] = corpus
    norms = np.sum(raw.astype(np.float64) ** 2, -1).astype(np.float32)
    pen = np.zeros(v_pad, np.float32)
    pen[n:] = BIG
    q = _queries(10, 16, d)
    from jax.sharding import NamedSharding, PartitionSpec as P
    jmesh = _jmesh()
    jargs = [jax.device_put(a, NamedSharding(jmesh, spec)) for a, spec in
             ((raw, P("l", None)), (norms, P("l")), (pen, P("l")))]
    jd, jid = _np(*jpar.sharded_flat_search_fn(
        jmesh, k=5, v_per_shard=v_pad // s)(jargs[0], jargs[1],
                                            jnp.asarray(q), jargs[2]))
    td, tid = _np(*tpar.sharded_flat_search_fn(
        _tmesh(), k=5, v_per_shard=v_pad // s)(
            torch.from_numpy(raw), torch.from_numpy(norms),
            torch.from_numpy(q), torch.from_numpy(pen)))
    ref = ((q[:, None, :] - corpus[None]) ** 2).sum(-1)
    oid = np.argsort(ref, axis=1)[:, :5]
    assert (np.sort(tid, 1) == np.sort(oid, 1)).mean() > 0.99
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-3)
    assert (np.sort(tid, 1) == np.sort(jid, 1)).mean() > 0.99


def _objective(x, c):
    return np.asarray(jpairwise_l2(jnp.asarray(x), jnp.asarray(c))
                      ).min(axis=1).mean()


def test_sharded_kmeans_matches_single():
    """Sharded data-parallel Lloyd == the JAX function from the same
    init (centroids to 1e-4, the same counts), and its objective is
    the single-device Lloyd's without rebalancing within 1%."""
    x = make_blobs(np.random.default_rng(11), 2000, 32)
    k = 16
    init = x[:k]
    jc, jn = _np(*jpar.sharded_kmeans_fit(_jmesh(), x, init, k=k, iters=8))
    tc, tn = _np(*tpar.sharded_kmeans_fit(_tmesh(), x, init, k=k, iters=8))
    assert tn.sum() == x.shape[0]
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-4)
    ref, _ = tkm.kmeans_fit(torch.from_numpy(x), torch.from_numpy(init),
                            k=k, iters=8, rebalance=0)
    assert _objective(x, tc) <= _objective(x, ref.numpy()) * 1.01
    jref, _ = jkm.kmeans_fit(jnp.asarray(x), jnp.asarray(init), k=k,
                             iters=8, rebalance=0)
    assert _objective(x, jc) <= _objective(x, np.asarray(jref)) * 1.01


def test_sharded_kmeans_same_bits_and_layouts():
    """Two fits from one init give the same bits, and every mesh layout
    (rows split over 1, 2 or 8 shards) the same counts."""
    x = make_blobs(np.random.default_rng(12), 3001, 16)
    init = x[:8]
    a = tpar.sharded_kmeans_fit(_tmesh(), x, init, k=8, iters=5)
    b = tpar.sharded_kmeans_fit(_tmesh(), x, init, k=8, iters=5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for l, q in ((1, 1), (2, 1), (8, 1)):
        c, n = tpar.sharded_kmeans_fit(_tmesh(l, q), x, init, k=8, iters=5)
        np.testing.assert_array_equal(n.numpy(), a[1].numpy())
        np.testing.assert_allclose(c.numpy(), a[0].numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------
# mesh, layout and collectives
# ---------------------------------------------------------------------

def test_build_mesh_grid_and_checks():
    devs = [torch.device("cpu")] * 6
    m = tpar.build_mesh(3, 2, devs)
    assert m.shape == {"q": 2, "l": 3}
    assert m.devices == [devs[:3], devs[3:]]
    jm = _jmesh(3, 2)
    assert dict(jm.shape) == m.shape
    with pytest.raises(ValueError, match="needs 8 devices"):
        tpar.build_mesh(4, 2, devs)


def test_collectives_keep_shard_order():
    parts = [torch.full((2, 1), float(i)) for i in range(4)]
    got = tsh.all_gather(parts, 1)
    assert len(got) == 4
    for g in got:
        assert g.tolist() == [[0.0, 1.0, 2.0, 3.0]] * 2
    assert all(s.tolist() == [[6.0]] * 2 for s in tsh.psum(parts))


@pytest.mark.parametrize("nlist", [30, 64])
def test_shard_layouts_match_jax(nlist, tmp_path):
    """shard_ivfpq / shard_ivfsq / shard_dense lay out the same arrays
    shard by shard: lists padded to a multiple of S (padded centroids
    1e18, their norms summed in f64), trimmed to cap_eff, docids and
    vids global."""
    x = make_blobs(np.random.default_rng(13), 3000, 32)
    jm, tm = _build(tmp_path, x, JIndex, TIndex,
                    {"ncentroids": nlist, "nsubvector": 8, "nprobe": 8})
    jmesh, tmesh = _jmesh(4, 1), _tmesh(4, 1)
    jsh, tshd = _shard_pq(jm, tm, jmesh, tmesh)
    jsq, tsq = _shard_sq(jm, tm, jmesh, tmesh)

    def shards(a):
        return [np.asarray(s.data) for s in sorted(
            a.addressable_shards, key=lambda s: s.index[0].start or 0)]

    pairs = [(jsh.state.vids, tshd.state.vids),
             (jsh.state.docids, tshd.state.docids),
             (jsh.state.lens, tshd.state.lens),
             (jsh.state.codes, tshd.state.codes),
             (jsh.centroids, tshd.centroids),
             (jsh.cent_norms, tshd.cent_norms),
             (jsq.sq_codes, tsq.sq_codes), (jsq.sq_norms, tsq.sq_norms),
             (jsq.docids, tsq.docids), (jsq.centroids, tsq.centroids)]
    for ja, ta in pairs:
        assert tuple(ja.shape) == ta.shape
        for i, js in enumerate(shards(ja)):
            np.testing.assert_array_equal(ta.local(0, i).numpy(), js)
    assert tshd.v_per_shard == jsh.v_per_shard
    assert tshd.raw.shape == tuple(jsh.raw.shape)
    if nlist % 4:
        pad = tshd.centroids.local(0, 3).numpy()[nlist % 4 - 4:]
        assert np.all(pad == np.float32(1e18))
        assert np.all(np.isfinite(tshd.cent_norms.local(0, 3).numpy()))


# ---------------------------------------------------------------------
# the engine's sharded search
# ---------------------------------------------------------------------

def _engine(pkg, path, n_docs, x, params, indexing_size, indexed=False,
            **cfg):
    kw = {"device": "cpu"} if pkg is gamma_tpu_torch else {}
    eng = pkg.GammaEngine(pkg.EngineConfig(path=str(path), **cfg), **kw)
    dt = pkg.config.DataType
    eng.create_table(pkg.TableInfo(
        name="sh", fields=[pkg.FieldInfo("price", dt.FLOAT, indexed)],
        vectors=[pkg.VectorInfo("vec", x.shape[1])],
        indexing_size=indexing_size, retrieval_types=["IVFPQ"],
        retrieval_params=[params]))
    _add(pkg, eng, x, 0, n_docs)
    return eng


def _add(pkg, eng, x, start, end, key="k", price=None, shift=0.0):
    eng.add_or_update_docs([
        pkg.Doc(key=f"{key}{i}",
                fields={"price": float(i) if price is None else price},
                vectors={"vec": x[i] + shift}) for i in range(start, end)])
    eng.flush()


def _hits(pkg, eng, q, topn=5, **kw):
    r = eng.search(pkg.Request(topn=topn,
                               vec_fields=[pkg.VectorQuery("vec", q)], **kw))
    return [[it.docid for it in sr.result_items] for sr in r.results]


def _enable(pkg, eng, l=4, q=2):
    if pkg is gamma_tpu_torch:
        eng.enable_sharded_search(n_list_shards=l, n_query_shards=q,
                                  devices=CPU8)
    else:
        eng.enable_sharded_search(n_list_shards=l, n_query_shards=q)


PKGS = [gamma_tpu, gamma_tpu_torch]
ENG_PARAMS = {"ncentroids": 32, "nsubvector": 8, "nprobe": 32}


@pytest.mark.parametrize("mode", ["dense", "gather"])
def test_engine_sharded_search(tmp_path, mode):
    """Engine-level sharded serving in both modes (dense: the mirror;
    gather: the SQ8 sidecar, test_engine_sharded_sq8_gather): top-1 and
    overlap with the engine's own search, filters respected, the
    realtime tail merged — on both engines.  The port's engine loads the
    JAX engine's dump, so both shard one index: their sharded answers
    agree to 1e-4 (dense: exact rerank) or 1e-2 (SQ8: bf16 query
    operand)."""
    x = np.random.default_rng(14).normal(size=(2000, 32)).astype(
        np.float32)
    params = dict(ENG_PARAMS, scan_mode=mode)
    jeng = _engine(gamma_tpu, tmp_path, 2000, x, params, 1500,
                   indexed=True, native_persistence=False)
    assert jeng.dump() == 0
    teng = gamma_tpu_torch.GammaEngine(gamma_tpu_torch.EngineConfig(
        path=str(tmp_path), native_persistence=False), device="cpu")
    assert teng.load() == 0
    got = {}
    for pkg, eng in ((gamma_tpu, jeng), (gamma_tpu_torch, teng)):
        ref = _hits(pkg, eng, x[:8])
        _enable(pkg, eng)
        res = eng.search(pkg.Request(topn=5, vec_fields=[
            pkg.VectorQuery("vec", x[:8])]))
        hits = [[it.docid for it in sr.result_items] for sr in res.results]
        got[pkg] = np.array([[it.score for it in sr.result_items]
                             for sr in res.results])
        sh = eng._sharded
        if mode == "gather":
            assert sh["sq"] is not None and sh["index"] is None
        else:
            assert sh["dense"] is not None
        for b in range(8):
            assert hits[b][0] == b == ref[b][0]
            assert len(set(ref[b]) & set(hits[b])) >= 3
        fr = _hits(pkg, eng, x[:8], range_filters=[
            pkg.RangeFilter("price", 1000.0, 1999.0)])
        assert all(1000 <= d <= 1999 for row in fr for d in row)
        # realtime tail: new docs after the snapshot come back
        _add(pkg, eng, x, 0, 4, key="t", price=0.5, shift=0.001)
        tr = _hits(pkg, eng, x[:4], topn=3)
        for b in range(4):
            assert 2000 + b in tr[b] or b in tr[b]
        eng.disable_sharded_search()
        assert eng._sharded is None
        eng.close()
    # SQ8: the JAX engine's body scans in f32 ("xla"), the port's
    # rounds the query operand to bf16, an error of ~1e-2 of the
    # distances' scale whatever the distance
    jd = got[gamma_tpu]
    if mode == "dense":
        np.testing.assert_allclose(got[gamma_tpu_torch], jd, rtol=1e-4,
                                   atol=1e-3)
    else:
        np.testing.assert_allclose(got[gamma_tpu_torch], jd, rtol=1e-2,
                                   atol=1e-2 * np.abs(jd).max())


def test_engine_sharded_dense_dispatch(tmp_path):
    """The dense snapshot serves a dense request, with the pre-sharding
    top-1 on both engines."""
    x = np.random.default_rng(15).normal(size=(1500, 32)).astype(
        np.float32)
    for pkg in PKGS:
        eng = _engine(pkg, tmp_path / pkg.__name__, 1500, x,
                      {"ncentroids": 32, "nsubvector": 8}, 1000)
        req = pkg.Request(topn=5, vec_fields=[pkg.VectorQuery("vec", x[:8])],
                          retrieval_params={"scan_mode": "dense"})
        ref = eng.search(req)
        _enable(pkg, eng)
        got = eng.search(req)
        assert eng._sharded["dense"] is not None
        for b in range(8):
            assert (got.results[b].result_items[0].docid
                    == ref.results[b].result_items[0].docid == b)
        eng.close()


def test_engine_sharded_single_query_padding(tmp_path):
    """A 1- or 3-query request on a 2-way query mesh pads, not fails."""
    x = np.random.default_rng(16).normal(size=(1200, 32)).astype(
        np.float32)
    for pkg in PKGS:
        eng = _engine(pkg, tmp_path / pkg.__name__, 1200, x,
                      {"ncentroids": 16, "nsubvector": 8}, 900)
        _enable(pkg, eng)
        for nq in (1, 3):
            hits = _hits(pkg, eng, x[:nq])
            assert len(hits) == nq
            assert [h[0] for h in hits] == list(range(nq))
        eng.close()


def test_engine_sharded_no_tail_duplicates(tmp_path):
    """Rows indexed between enable_sharded_search() and the lazy snapshot
    build appear once (the extent is taken with the snapshot)."""
    x = np.random.default_rng(17).normal(size=(1400, 32)).astype(
        np.float32)
    for pkg in PKGS:
        eng = _engine(pkg, tmp_path / pkg.__name__, 1000, x,
                      {"ncentroids": 16, "nsubvector": 8}, 800)
        _enable(pkg, eng, 4, 1)
        _add(pkg, eng, x, 1000, 1400)
        got = _hits(pkg, eng, x[1200:1201], topn=10)[0]
        assert got[0] == 1200
        assert len(got) == len(set(got)), f"duplicate docids: {got}"
        eng.close()


def test_engine_sharded_realtime_tail(tmp_path):
    """Docs ingested after the snapshot stay searchable, and so do the
    snapshot's."""
    x = np.random.default_rng(18).normal(size=(1300, 32)).astype(
        np.float32)
    for pkg in PKGS:
        eng = _engine(pkg, tmp_path / pkg.__name__, 1000, x,
                      {"ncentroids": 16, "nsubvector": 8}, 800)
        _enable(pkg, eng, 4, 1)
        assert _hits(pkg, eng, x[5:6], topn=3)[0][0] == 5   # snapshot
        _add(pkg, eng, x, 1000, 1300)
        assert _hits(pkg, eng, x[1250:1251], topn=3)[0][0] == 1250
        assert _hits(pkg, eng, x[10:11], topn=3)[0][0] == 10
        eng.close()


@pytest.mark.parametrize("payload", ["sq8", "pq"])
def test_engine_sharded_delete_after_snapshot(tmp_path, payload):
    """A doc deleted after the snapshot vanishes (the validity fast path
    is off once a delete follows the snapshot), on both engines."""
    x = np.random.default_rng(19).normal(size=(1500, 32)).astype(
        np.float32)
    params = dict(ENG_PARAMS, scan_mode="gather", gather_payload=payload)
    for pkg in PKGS:
        eng = _engine(pkg, tmp_path / pkg.__name__, 1500, x, params, 1000)
        _enable(pkg, eng)
        assert _hits(pkg, eng, x[7:8])[0][0] == 7
        mode = "sq" if payload == "sq8" else "index"
        assert eng._sharded[mode] is not None
        assert eng.delete("k7") == 0
        eng.flush()
        assert 7 not in _hits(pkg, eng, x[7:8])[0]
        eng.close()


def test_engine_sharded_default_devices_cpu(tmp_path):
    """On the CPU the default mesh is the engine's device once (1 x 1),
    and the sharded answers equal the engine's own."""
    x = np.random.default_rng(20).normal(size=(1500, 32)).astype(
        np.float32)
    eng = _engine(gamma_tpu_torch, tmp_path, 1500, x,
                  dict(ENG_PARAMS, scan_mode="gather"), 1000)
    ref = eng.search(gamma_tpu_torch.Request(topn=5, vec_fields=[
        gamma_tpu_torch.VectorQuery("vec", x[:16])]))
    eng.enable_sharded_search()
    assert eng._sharded["mesh"].shape == {"q": 1, "l": 1}
    got = eng.search(gamma_tpu_torch.Request(topn=5, vec_fields=[
        gamma_tpu_torch.VectorQuery("vec", x[:16])]))
    for a, b in zip(ref.results, got.results):
        assert ([it.docid for it in a.result_items]
                == [it.docid for it in b.result_items])
        np.testing.assert_allclose([it.score for it in b.result_items],
                                   [it.score for it in a.result_items],
                                   rtol=1e-5, atol=1e-5)
    eng.close()


def test_engine_sharded_snapshot_and_count_together(tmp_path, monkeypatch):
    """The snapshot and the indexed count are read together: an ingest
    started right after the snapshot is read, before the count is (the
    hazard: its rows counted but not in the snapshot, so neither the
    snapshot nor the realtime tail would serve them), waits for the
    count, and its rows are served by the tail exactly once."""
    x = np.random.default_rng(21).normal(size=(1400, 32)).astype(
        np.float32)
    eng = _engine(gamma_tpu_torch, tmp_path, 1000, x,
                  dict(ENG_PARAMS, scan_mode="gather"), 800)
    model = eng.vm.index_for("vec")
    _enable(gamma_tpu_torch, eng, 4, 1)
    real = model._snapshot
    adders = []

    def snapshot_then_ingest():
        snap = real()
        if not adders and (sys._getframe(1).f_code.co_name
                           == "_sharded_snapshot"):
            t = threading.Thread(target=_add, args=(gamma_tpu_torch, eng, x,
                                                    1000, 1400))
            adders.append(t)
            t.start()
            t.join(timeout=2.0)     # done by now unless it must wait
        return snap

    monkeypatch.setattr(model, "_snapshot", snapshot_then_ingest)
    _hits(gamma_tpu_torch, eng, x[:1])
    monkeypatch.setattr(model, "_snapshot", real)
    assert adders
    adders[0].join(timeout=60)
    assert not adders[0].is_alive()
    assert eng._sharded["sq"][1] == 1000        # the count of the snapshot
    for i in (1000, 1300, 1399):
        got = _hits(gamma_tpu_torch, eng, x[i:i + 1], topn=10)[0]
        assert got[0] == i and len(got) == len(set(got)), (i, got)
    eng.close()


def test_engine_sharded_pq_rerank_needs_the_mirror(tmp_path):
    """On the disk tier the store holds no device mirror (an 8-row
    placeholder): the sharded PQ search's owner-computes rerank would
    read it, so it raises; the SQ8 sidecar needs no rows and serves."""
    x = np.random.default_rng(22).normal(size=(1500, 32)).astype(
        np.float32)
    for payload in ("pq", "sq8"):
        pkg = gamma_tpu_torch
        eng = pkg.GammaEngine(pkg.EngineConfig(path=str(tmp_path / payload)),
                              device="cpu")
        eng.create_table(pkg.TableInfo(
            name="sh", fields=[pkg.FieldInfo("price", pkg.DataType.FLOAT)],
            vectors=[pkg.VectorInfo("vec", 32, store_type="RocksDB")],
            indexing_size=1000, retrieval_types=["IVFPQ"],
            retrieval_params=[dict(ENG_PARAMS, gather_payload=payload)]))
        _add(pkg, eng, x, 0, 1500)
        _enable(pkg, eng)
        if payload == "pq":
            with pytest.raises(RuntimeError, match="device mirror"):
                _hits(pkg, eng, x[:4])
        else:
            assert [h[0] for h in _hits(pkg, eng, x[:4])] == [0, 1, 2, 3]
        eng.close()


# the three scan modes of the sharded search, every list probed
SNAP_MODES = {"sq": dict(ENG_PARAMS, scan_mode="gather"),
              "index": dict(ENG_PARAMS, scan_mode="gather",
                            gather_payload="pq"),
              "dense": dict(ENG_PARAMS, scan_mode="dense")}


def _single_and_sharded(eng, q, topn=5, **kw):
    """(single, sharded) answers of the port's engine to one request:
    [(docids, scores)] a query, the single one with the mesh set aside."""
    pkg = gamma_tpu_torch
    req = pkg.Request(topn=topn, vec_fields=[pkg.VectorQuery("vec", q)],
                      **kw)

    def answer():
        return [([it.docid for it in sr.result_items],
                 [it.score for it in sr.result_items])
                for sr in eng.search(req).results]

    sh, eng._sharded = eng._sharded, None
    try:
        single = answer()
    finally:
        eng._sharded = sh
    return single, answer()


def _same_answers(single, sharded):
    for (ids_a, sc_a), (ids_b, sc_b) in zip(single, sharded):
        assert len(ids_b) == len(set(ids_b)), f"a docid twice: {ids_b}"
        assert ids_b[0] == ids_a[0], (ids_a, ids_b)
        np.testing.assert_allclose(sc_b, sc_a, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("mode", sorted(SNAP_MODES))
def test_engine_sharded_snapshot_serves_only_mirrored_rows(tmp_path, mode,
                                                           filtered):
    """Docs indexed from host rows past the store mirror (added, pumped,
    not flushed) when the snapshot is taken: the snapshot serves only
    the rows its mirror holds and the docs marked live, so the sharded
    search answers as the single engine, which hides those docs; once
    they are flushed the realtime tail serves them, with their own
    distances.  With a filter the validity fast path is off: the
    snapshot still masks past its count."""
    pkg = gamma_tpu_torch
    x = np.random.default_rng(23).normal(size=(2600, 32)).astype(
        np.float32)
    eng = _engine(pkg, tmp_path, 2000, x, SNAP_MODES[mode], 1500,
                  indexed=True)
    _enable(pkg, eng)
    eng.add_or_update_docs([
        pkg.Doc(key=f"k{i}", fields={"price": float(i)},
                vectors={"vec": x[i]}) for i in range(2000, 2600)])
    assert eng.vm.add_rt_vecs_to_index() == 600
    kw = ({"range_filters": [pkg.RangeFilter("price", 0.0, 1e9)]}
          if filtered else {})
    q = x[[5, 1500, 2100, 2300, 2599]]
    single, sharded = _single_and_sharded(eng, q, **kw)
    assert all(d < 2000 for ids, _ in sharded for d in ids)
    _same_answers(single, sharded)
    eng.flush()
    single, sharded = _single_and_sharded(eng, q, **kw)
    assert [ids[0] for ids, _ in sharded] == [5, 1500, 2100, 2300, 2599]
    _same_answers(single, sharded)
    assert eng._sharded[mode][1] == 2000          # the mirrored rows
    eng.close()


def _multi_engine(path, x, n_docs, payload):
    """The port's engine over docs of two vectors each (x [n, 2, d])."""
    pkg = gamma_tpu_torch
    eng = pkg.GammaEngine(pkg.EngineConfig(path=str(path)), device="cpu")
    eng.create_table(pkg.TableInfo(
        name="sh", fields=[pkg.FieldInfo("price", pkg.DataType.FLOAT)],
        vectors=[pkg.VectorInfo("vec", x.shape[2])], indexing_size=800,
        retrieval_types=["IVFPQ"],
        retrieval_params=[dict(ENG_PARAMS, scan_mode="gather",
                               gather_payload=payload)]))
    _add_multi(eng, x, 0, n_docs)
    return eng


def _add_multi(eng, x, start, end, flush=True):
    pkg = gamma_tpu_torch
    assert eng.add_or_update_docs([
        pkg.Doc(key=f"k{i}", fields={"price": float(i)},
                vectors={"vec": x[i]}) for i in range(start, end)]) == [
                    0] * (end - start)
    if flush:
        eng.flush()


@pytest.mark.parametrize("payload", ["sq8", "pq"])
def test_engine_sharded_tail_multi_vector(tmp_path, payload):
    """Two vectors a doc: the snapshot at 1,000 docs (2,000 vids), then
    200 docs more.  The realtime tail masks the docs the snapshot holds,
    not the docids below its vid count, so docs 1100 and 1199 are found
    by either of their vectors, as the single engine finds them."""
    x = np.random.default_rng(24).normal(size=(1200, 2, 32)).astype(
        np.float32)
    eng = _multi_engine(tmp_path, x, 1000, payload)
    assert eng.vm.stores["vec"].vid_mgr.multi
    _enable(gamma_tpu_torch, eng)
    _single_and_sharded(eng, x[:4, 0])
    _add_multi(eng, x, 1000, 1200)
    for v in (0, 1):
        single, sharded = _single_and_sharded(eng, x[[5, 1100, 1199], v])
        assert [ids[0] for ids, _ in single] == [5, 1100, 1199]
        _same_answers(single, sharded)
    mode = "sq" if payload == "sq8" else "index"
    assert eng._sharded[mode][1:4:2] == (2000, 1000)    # vids, docs
    eng.close()


@pytest.mark.parametrize("payload", ["sq8", "pq"])
def test_engine_sharded_doc_straddling_the_count(tmp_path, payload):
    """A snapshot taken while the indexed count splits a doc's two vids
    (a pump chunk ended inside it): the snapshot's count is cut back to
    the doc's first vid, the tail serves the doc whole, and it is found
    once, by either vector."""
    x = np.random.default_rng(25).normal(size=(1200, 2, 32)).astype(
        np.float32)
    eng = _multi_engine(tmp_path, x, 1000, payload)
    model = eng.vm.index_for("vec")
    store = eng.vm.stores["vec"]
    pump = eng.vm.add_rt_vecs_to_index
    eng.vm.add_rt_vecs_to_index = lambda: 0
    _add_multi(eng, x, 1000, 1200)              # mirrored and live
    vids = np.arange(2000, 2201)                # doc 1100 split: 2200 | 2201
    with model.mutate_lock:
        model.add(store.header(2000, 2201), vids,
                  store.vid_mgr.vid2doc(vids))
    _enable(gamma_tpu_torch, eng)
    _single_and_sharded(eng, x[:4, 0])
    eng.vm.add_rt_vecs_to_index = pump
    eng.flush()
    assert model.indexed_count == 2400
    for v in (0, 1):
        single, sharded = _single_and_sharded(
            eng, x[[1099, 1100, 1101, 1199], v])
        assert [ids[0] for ids, _ in single] == [1099, 1100, 1101, 1199]
        _same_answers(single, sharded)
    mode = "sq" if payload == "sq8" else "index"
    assert eng._sharded[mode][1:4:2] == (2200, 1100)    # vids, docs
    eng.close()
