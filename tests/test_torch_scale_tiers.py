"""The JAX package's two published scale configurations at CPU scale,
through both packages on the same numpy inputs: bench.py's 10M sequence
over the three capacity tiers (docs/CAPACITY_TIERS.md) and VGG-1M's
geometry (d 512, M 64).  chip_smoke.py's phases D-10M and D-vgg run the
port's side of both at full scale on the card.

Both sides train from the same draws: the port's random k-means and PQ
inits (`torch.randperm` on a generator seeded with the call's seed) are
replaced by the JAX package's (`jax.random.permutation` of the same
seed), so the centroids after the rebalance rounds and the codebooks
can be compared.  The JAX side searches on its TPU code path with the
Pallas kernels interpreted, as tests/test_torch_ivfpq.py runs it.

Tolerances: centroids and codebooks 1e-4 (f32 sums of the same rows in
another order, over 22 Lloyd passes); searches are compared by the
exact float64 distances of each side's chosen ids, sorted, to 1e-4
relative (near-ties may pick other ids of the same distance, ROADMAP.md
"Near-ties"); SQ8 ranges 1e-4, codes one step apart at most where a
bf16 mirror row sits on a rounding edge."""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.config import SearchParams as JSP
from gamma_tpu.index.ivfpq import IVFPQIndex as JIndex
from gamma_tpu.ops import kmeans as jkm
from gamma_tpu.ops import pallas_adc as jadc
from gamma_tpu.ops import pallas_gadc as jgadc
from gamma_tpu.ops import pallas_gsq as jgsq
from gamma_tpu.vector.raw_store import RawVectorStore as JStore
from gamma_tpu_torch.config import SearchParams as TSP
from gamma_tpu_torch.index.ivfpq import IVFPQIndex as TIndex
from gamma_tpu_torch.index.ivfpq_fastscan import IVFPQFastScanIndex as TFS
from gamma_tpu_torch.ops import kmeans as tkm
from gamma_tpu_torch.vector.raw_store import RawVectorStore as TStore

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import _make_corpus  # noqa: E402  (the TPU bench's generator)

# the 10M sequence cut to CPU scale: bench.py:1192-1338's parameters with
# nlist 2048 → 64, M 32 → 8, nprobe 64 → 16, add chunks 65,536 → 4,096
N, D, NLIST, M, NPROBE, CHUNK, NQ = 20_000, 32, 64, 8, 16, 4096, 48
TENM = {"ncentroids": NLIST, "nsubvector": M, "nprobe": NPROBE,
        "gather_payload": "pq", "train_rebalance": 6,
        "bucket_init_size": 3 * N // NLIST}
DENSE = {"scan_mode": "dense", "recall_num": 100, "has_rank": True}
GATHER = {"scan_mode": "gather", "nprobe": NPROBE, "recall_num": 100,
          "has_rank": True}
SQ8 = dict(GATHER, sq_rerank=True)
# VGG's geometry: d 512, M 64 (dsub 8), the default SQ8 payload, f32 rows
VGG_N, VGG_D, VGG_NLIST, VGG_M = 4096, 512, 32, 64
VGG = {"ncentroids": VGG_NLIST, "nsubvector": VGG_M, "nprobe": 8,
       "bucket_init_size": 4 * VGG_N // VGG_NLIST}
TOL = dict(rtol=1e-4, atol=1e-4)


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


@pytest.fixture
def same_draws(monkeypatch):
    """The port's k-means and PQ init draws replaced by the JAX
    package's: the same seed gives the same permutation on both sides."""
    def randperm(n, generator=None, **_):
        key = jax.random.PRNGKey(generator.initial_seed())
        return torch.from_numpy(
            np.asarray(jax.random.permutation(key, n)).astype(np.int64))
    monkeypatch.setattr(torch, "randperm", randperm)


def _data(n, d, seed, **geometry):
    """bench.py's corpus and NQ queries at +0.5 noise, from a local rng."""
    rng = np.random.default_rng(seed)
    x, _ = _make_corpus(n, d, 64, rng, **geometry)
    q = (x[rng.choice(n, NQ, replace=False)]
         + 0.5 * rng.normal(size=(NQ, d))).astype(np.float32)
    return x, q


def _stores(x, dtype):
    """A JAX and a port store of x, both mirrored in `dtype`."""
    d = x.shape[1]
    js = JStore("vec", d, device_dtype=getattr(jnp, dtype),
                init_cap=x.shape[0] + 64)
    ts = TStore("vec", d, device_dtype=getattr(torch, dtype),
                init_cap=x.shape[0] + 64, device="cpu")
    for s in (js, ts):
        s.add(x)
        s.flush_device()
    return js, ts


def _build(params, x, dtype, train_rows, chunk):
    """bench.py's build in both packages: train on the mirror's first
    rows, add every row from the mirror in chunks."""
    js, ts = _stores(x, dtype)
    jm, tm = JIndex(js, params), TIndex(ts, params)
    jm.train(js.device_rows(0, train_rows))
    tm.train(ts.device_rows(0, train_rows))
    ids = np.arange(x.shape[0])
    for s in range(0, x.shape[0], chunk):
        e = min(x.shape[0], s + chunk)
        jm.add(js.device_rows(s, e), ids[s:e], ids[s:e])
        tm.add(ts.device_rows(s, e), ids[s:e], ids[s:e])
    return jm, tm


def _pair(jm, tm, q, sp, k=10):
    """The same unfiltered request through both models → their ids."""
    n = jm.store.device.shape[0]
    _, dj, _ = jm.search(jnp.asarray(q), jnp.zeros(n, jnp.float32),
                         JSP.from_dict(sp), k, validity_n=jm.indexed_count)
    _, dt, _ = tm.search(torch.from_numpy(q), torch.zeros(n),
                         TSP.from_dict(sp), k, validity_n=tm.indexed_count)
    return np.asarray(dj), dt.numpy()


def _exact(x, q, ids):
    """Exact f64 L2 distances of each chosen id, sorted (inf for -1)."""
    d = ((q[:, None, :].astype(np.float64)
          - x[np.maximum(ids, 0)].astype(np.float64)) ** 2).sum(-1)
    return np.sort(np.where(ids >= 0, d, np.inf), 1)


def _same_quality(x, q, a, b):
    """Both sides chose ids at the same exact distances."""
    ea, eb = _exact(x, q, a), _exact(x, q, b)
    np.testing.assert_array_equal(np.isfinite(ea), np.isfinite(eb))
    np.testing.assert_allclose(eb[np.isfinite(eb)], ea[np.isfinite(ea)],
                               **TOL)


def _recall(x, q, ids):
    gt = np.argsort(((q[:, None, :].astype(np.float64) - x[None]) ** 2
                     ).sum(-1), 1)[:, :10]
    return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])


def _lists(state):
    lens = np.asarray(state.lens)
    docs = np.asarray(state.docids)
    return lens, [set(docs[i, :lens[i]].tolist()) - {-1}
                  for i in range(lens.size)]


def test_flush_device_uploads_in_bounded_chunks(monkeypatch):
    """flush_device uploads the host rows FLUSH_CHUNK_BYTES of f32 at a
    time: at 10M x 128 one upload of every row put 5 GB of f32 rows on
    the card, and with their bf16 cast and squares a 16.8 GB peak
    beside a 2.45 GB mirror (chip_smoke.py's D-10M).  No host block
    handed to torch exceeds the chunk, and the mirror and its norms are
    the JAX package's over two flushes, the second past the capacity."""
    from gamma_tpu_torch.vector import raw_store
    monkeypatch.setattr(raw_store, "FLUSH_CHUNK_BYTES", 100 * 4 * D)
    x, _ = _data(2500, D, 6)
    seen = []
    from_numpy = torch.from_numpy

    def spy(a):
        if a.ndim == 2 and a.shape[1] == D:
            seen.append(a.shape[0])
        return from_numpy(a)

    monkeypatch.setattr(torch, "from_numpy", spy)
    js = JStore("vec", D, init_cap=1024)
    ts = TStore("vec", D, init_cap=1024, device="cpu")
    for s in (js, ts):
        s.add(x[:1000])
        s.flush_device()
        s.add(x[1000:])
        s.flush_device()
    assert ts.flushed == 2500 and seen and max(seen) <= 100
    np.testing.assert_array_equal(
        ts.device[:2500].float().numpy(),
        np.asarray(js.device[:2500].astype(jnp.float32)))
    np.testing.assert_allclose(ts.device_norms[:2500].numpy(),
                               np.asarray(js.device_norms[:2500]),
                               rtol=1e-6)


def test_rebalance_rounds_match_jax():
    """kmeans_fit from one init over the 10M geometry's train set cut to
    CPU scale (nlist x 256 rows): the same centroids and counts after
    10 Lloyd passes and 6 rounds of (Lloyd, split the biggest clusters
    into the smallest slots, Lloyd); the rounds shorten the longest
    list."""
    x, _ = _data(NLIST * 256, D, 1)
    init = x[np.random.default_rng(2).choice(x.shape[0], NLIST,
                                             replace=False)]
    jc, jn = jkm.kmeans_fit(jnp.asarray(x), jnp.asarray(init), k=NLIST,
                            iters=10, rebalance=6)
    tc, tn = tkm.kmeans_fit(torch.from_numpy(x), torch.from_numpy(init),
                            k=NLIST, iters=10, rebalance=6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _, unbalanced = tkm.kmeans_fit(torch.from_numpy(x),
                                   torch.from_numpy(init), k=NLIST,
                                   iters=10, rebalance=0)
    assert tn.max() < unbalanced.max()


@pytest.mark.parametrize("model", ["ivfpq", "fastscan_raw"])
def test_train_on_device_rows_matches_jax(same_draws, model):
    """train() takes a store mirror's device rows (bf16), as bench.py
    trains at both scales: the port clamps them to nlist x 256 rows by
    the JAX package's strided subset of device arrays, on their device,
    and fits the same quantizers as the JAX package on the same rows."""
    x, _ = _data(6000, D, 3)
    js, ts = _stores(x, "bfloat16")
    params = {"ncentroids": 16, "nsubvector": M, "nprobe": 4,
              "gather_payload": "pq", "train_rebalance": 6}
    if model == "fastscan_raw":
        from gamma_tpu.index.ivfpq_fastscan import (IVFPQFastScanIndex
                                                    as JFS)
        params = dict(params, nsubvector=2 * M, by_residual=False)
        jm, tm = JFS(js, params), TFS(ts, params)
    else:
        jm, tm = JIndex(js, params), TIndex(ts, params)
    rows = ts.device_rows(0, 6000)
    assert rows.dtype == torch.bfloat16 and 6000 > 16 * 256
    jm.train(js.device_rows(0, 6000))
    tm.train(rows)
    assert tm.trained()
    np.testing.assert_allclose(tm.centroids.numpy(),
                               np.asarray(jm.centroids), **TOL)
    np.testing.assert_allclose(tm.pq.codebooks.numpy(),
                               np.asarray(jm.pq.codebooks), **TOL)
    sel = tm.clamp_train_set(rows)
    np.testing.assert_array_equal(
        sel.float().numpy(),
        np.asarray(jm.clamp_train_set(js.device_rows(0, 6000))
                   .astype(jnp.float32)))


def test_capacity_tiers_sequence_matches_jax(jax_tpu_path, same_draws):
    """bench.py's 10M sequence at CPU scale, step by step in both
    packages: train (rebalance 6) on bf16 mirror rows, add in chunks to
    lists presized to 3x the mean, the dense scan, one gather request
    over the PQ codes, release_recon(), build_sq_sidecar(), and the SQ8
    tier's gather with sq_rerank."""
    x, q = _data(N, D, 4)
    jm, tm = _build(TENM, x, "bfloat16", NLIST * 256, CHUNK)
    # the quantizers after the rebalance rounds
    np.testing.assert_allclose(tm.centroids.numpy(),
                               np.asarray(jm.centroids), **TOL)
    np.testing.assert_allclose(tm.pq.codebooks.numpy(),
                               np.asarray(jm.pq.codebooks), **TOL)
    assert not tm.sq_active and not jm.sq_active
    assert tm.state.cap == jm.state.cap == 3 * N // NLIST
    jl, jsets = _lists(jm.state)
    tl, tsets = _lists(tm.state)
    np.testing.assert_array_equal(tl, jl)
    assert tsets == jsets
    assert tm._cap_eff() == jm._cap_eff()

    # the dense scan, then the gather tier over the PQ codes
    assert tm.scan_mode(TSP.from_dict(DENSE)) == "dense"
    for sp in (DENSE, GATHER):
        a, b = _pair(jm, tm, q, sp)
        _same_quality(x, q, a, b)
        assert _recall(x, q, b) >= 0.9, sp

    # the capacity tier: no mirror, the SQ8 sidecar built after the fact
    for m in (jm, tm):
        m.release_recon()
    assert tm.recon.shape[0] == 8 and not tm.keep_recon
    assert tm.scan_mode(TSP.from_dict(DENSE)) == "gather"
    assert jm.build_sq_sidecar() and tm.build_sq_sidecar()
    ce = tm._cap_eff()
    assert tuple(tm.sq_codes.shape) == tuple(jm.sq_codes.shape) == (
        NLIST, ce, 128)
    assert (tm.sq_codes.numel() + tm.sq_norms.numel() * 4
            == NLIST * ce * (128 + 4))
    np.testing.assert_allclose(tm.sq_scale.numpy(), np.asarray(jm.sq_scale),
                               **TOL)
    np.testing.assert_allclose(tm.sq_off.numpy(), np.asarray(jm.sq_off),
                               **TOL)
    live = ((np.arange(ce)[None, :] < tl[:, None])
            & (tm.state.vids.numpy()[:, :ce] >= 0))
    tc = tm.sq_codes.numpy()[live].astype(np.int32)
    jc = np.asarray(jm.sq_codes)[live].astype(np.int32)
    assert np.abs(tc - jc).max() <= 1 and (tc == jc).mean() >= 0.99
    a, b = _pair(jm, tm, q, SQ8)
    _same_quality(x, q, a, b)
    assert _recall(x, q, b) >= 0.9


def test_vgg_geometry_matches_jax(jax_tpu_path, same_draws):
    """VGG-1M's geometry at CPU scale (bench.py:1092-1145): d 512 rows
    from a 24-dim manifold in an f32 store, M 64 (dsub 8), the default
    SQ8 payload (d_pad 512), lists presized to 4x the mean; the dense
    scan and an SQ8 gather request with sq_rerank agree with the JAX
    package's."""
    x, q = _data(VGG_N, VGG_D, 5, intrinsic=24)
    jm, tm = _build(VGG, x, "float32", VGG_N, 1024)
    np.testing.assert_allclose(tm.centroids.numpy(),
                               np.asarray(jm.centroids), **TOL)
    assert tm.sq_active and jm.sq_active and tm._sq_d_pad == 512
    assert tuple(tm.sq_codes.shape) == tuple(jm.sq_codes.shape)
    for sp in (DENSE, SQ8):
        a, b = _pair(jm, tm, q, sp)
        _same_quality(x, q, a, b)
        assert _recall(x, q, b) >= 0.9, sp
