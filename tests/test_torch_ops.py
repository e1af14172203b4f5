"""Parity of the port's op primitives (gamma_tpu_torch.ops) with the JAX
package: the same numpy inputs go through both, compared at 1e-5
relative (codes exact).  Random draws that the two frameworks cannot
share (k-means init, PQ init) are injected."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.ops import distances as jd
from gamma_tpu.ops import flat_scan as jf
from gamma_tpu.ops import kmeans as jk
from gamma_tpu.ops import penalty as jp
from gamma_tpu.ops import pq as jpq
from gamma_tpu.ops import topk as jt
from gamma_tpu_torch.ops import distances as td
from gamma_tpu_torch.ops import flat_scan as tf
from gamma_tpu_torch.ops import kmeans as tk
from gamma_tpu_torch.ops import penalty as tp
from gamma_tpu_torch.ops import pq as tpq
from gamma_tpu_torch.ops import topk as tt

RTOL = 1e-5
BIG = 3.0e38


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _blobs(rng, n, d, k, scale=0.2):
    centers = rng.normal(size=(k, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, k, n)] + scale * rng.normal(size=(n, d))
    return x.astype(np.float32)


def test_constants_match():
    assert td.BIG == jd.BIG


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pairwise_dist(metric):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(7, 24)).astype(np.float32)
    x = rng.normal(size=(50, 24)).astype(np.float32)
    ref = np.asarray(jd.pairwise_dist(jnp.asarray(q), jnp.asarray(x), metric))
    got = td.pairwise_dist(_t(q), _t(x), metric).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(td.l2_norms(_t(x)).numpy(),
                               np.asarray(jd.l2_norms(jnp.asarray(x))),
                               rtol=RTOL)


def test_pairwise_l2_bf16_rows():
    """A bf16 store mirror is upcast exactly; norms come from the
    stored rows."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    x = rng.normal(size=(40, 16)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xs = xb.float().numpy()
    got = td.pairwise_l2(_t(q), xb, td.l2_norms(xb)).numpy()
    ref = np.asarray(jd.pairwise_l2(jnp.asarray(q), jnp.asarray(xs)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("k", [3, 12])
def test_topk_min_padding(k):
    """k past the candidate count pads with (BIG, -1), as the JAX op."""
    rng = np.random.default_rng(2)
    d = rng.permutation(8).astype(np.float32).reshape(1, 8).repeat(3, 0)
    ids = np.arange(8, dtype=np.int32)[None].repeat(3, 0) + 100
    jv, ji = jt.topk_min(jnp.asarray(d), jnp.asarray(ids), k)
    tv, ti = tt.topk_min(_t(d), _t(ids), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if k > 8:
        assert np.all(tv.numpy()[:, 8:] == np.float32(BIG))
        assert np.all(ti.numpy()[:, 8:] == -1)


def test_merge_topk():
    rng = np.random.default_rng(3)
    d1, d2 = (rng.permutation(20)[:6].astype(np.float32)[None]
              for _ in range(2))
    i1, i2 = np.arange(6)[None], np.arange(6, 12)[None]
    jv, ji = jt.merge_topk(jnp.asarray(d1), jnp.asarray(i1),
                           jnp.asarray(d2), jnp.asarray(i2), 5)
    tv, ti = tt.merge_topk(_t(d1), _t(i1), _t(d2), _t(i2), 5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_penalty_ops_and_saturation():
    """mark_live/mark_deleted (out-of-range ids dropped, never a fault),
    range/mask penalties, and combine saturating at BIG."""
    v = tp.init_validity(16)
    jv = jp.init_validity(16)
    live = np.array([0, 3, 5, 40], np.int32)       # 40 is out of range
    v = tp.mark_live(v, _t(live))
    jv = jp.mark_live(jv, jnp.asarray(live))
    dead = np.array([3, 99], np.int32)
    v = tp.mark_deleted(v, _t(dead))
    jv = jp.mark_deleted(jv, jnp.asarray(dead))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    col = np.linspace(-2, 2, 16).astype(np.float32)
    for inc in [(True, True), (False, True), (True, False)]:
        np.testing.assert_array_equal(
            tp.range_penalty(_t(col), -0.5, 1.0, *inc).numpy(),
            np.asarray(jp.range_penalty(jnp.asarray(col), -0.5, 1.0, *inc)))
    mask = (np.arange(16) % 3 == 0).astype(np.uint8)
    m = tp.mask_penalty(_t(mask))
    np.testing.assert_array_equal(m.numpy(),
                                  np.asarray(jp.mask_penalty(
                                      jnp.asarray(mask))))
    parts = [v, m, tp.range_penalty(_t(col), 0.0, 2.0)]
    got = tp.combine(parts).numpy()
    ref = np.asarray(jp.combine([jnp.asarray(p.numpy()) for p in parts]))
    np.testing.assert_array_equal(got, ref)
    assert got.max() == np.float32(BIG) and np.isfinite(got).all()


@pytest.mark.parametrize("rebalance", [0, 2])
def test_kmeans_fit_injected_init(rebalance):
    rng = np.random.default_rng(4)
    x = _blobs(rng, 600, 16, 12)
    init = x[rng.choice(600, 12, replace=False)]
    jc, jn = jk.kmeans_fit(jnp.asarray(x), jnp.asarray(init), k=12,
                           iters=5, rebalance=rebalance)
    tc, tn = tk.kmeans_fit(_t(x), _t(init), k=12, iters=5,
                           rebalance=rebalance)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("k", [7, 64])
def test_cluster_sums_ordered(k):
    """The centroid update's sums: each cluster's rows added in ascending
    row order (a float64 sum to 1e-6, counts exact, empty clusters 0),
    the same bits on every call, and the bits of a sequential f32 sum —
    an accumulation whose order the device chose would differ from it."""
    rng = np.random.default_rng(31)
    n, d = 3000, 12
    x = rng.normal(size=(n, d)).astype(np.float32) * 3.0
    assign = rng.integers(0, k - 1, n)          # cluster k-1 stays empty
    sums, counts = tk._cluster_sums(_t(x), _t(assign), k)
    again, _ = tk._cluster_sums(_t(x), _t(assign), k)
    assert torch.equal(sums, again)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(assign, minlength=k))
    ref = np.zeros((k, d))
    np.add.at(ref, assign, x.astype(np.float64))
    np.testing.assert_allclose(sums.numpy(), ref, rtol=1e-5, atol=1e-4)
    assert (sums[k - 1] == 0).all()
    seq = np.zeros((k, d), np.float32)
    for i in range(n):
        seq[assign[i]] += x[i]
    np.testing.assert_array_equal(sums.numpy(), seq)


def test_rebalance_moves_small_slots():
    """_rebalance parity on a skewed count vector (donors/victims)."""
    rng = np.random.default_rng(5)
    cents = rng.normal(size=(8, 4)).astype(np.float32)
    counts = np.array([100, 1, 2, 50, 0, 40, 3, 30], np.float32)
    ref = np.asarray(jk._rebalance(jnp.asarray(cents), jnp.asarray(counts)))
    got = tk._rebalance(_t(cents), _t(counts)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_kmeans_batched_fit_injected_init():
    rng = np.random.default_rng(6)
    xs = np.stack([_blobs(rng, 300, 4, 8) for _ in range(3)])
    inits = np.stack([x[rng.choice(300, 8, replace=False)] for x in xs])
    jc, jn = jk.kmeans_batched_fit(jnp.asarray(xs), jnp.asarray(inits),
                                   k=8, iters=6)
    tc, tn = tk.kmeans_batched_fit(_t(xs), _t(inits), k=8, iters=6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_train_pq_distortion():
    """A fresh port training (its own random init) reaches the JAX
    package's distortion on the same data."""
    rng = np.random.default_rng(7)
    x = _blobs(rng, 2000, 16, 20, scale=0.5)
    jcb = jpq.train_pq(jnp.asarray(x), 4, nbits=4, iters=8)
    tcb = tpq.train_pq(_t(x), 4, nbits=4, iters=8)
    jrec = np.asarray(jpq.decode_pq(jcb, jpq.encode_pq(jcb, jnp.asarray(x))))
    trec = tpq.decode_pq(tcb, tpq.encode_pq(tcb, _t(x))).numpy()
    jdist = ((x - jrec) ** 2).sum(1).mean()
    tdist = ((x - trec) ** 2).sum(1).mean()
    assert tdist <= 1.1 * jdist, (tdist, jdist)


@pytest.mark.parametrize("d,m", [(16, 4), (18, 4)])
def test_encode_decode_pq_same_codebooks(d, m):
    """Same codebooks → identical codes and reconstructions (d not a
    multiple of M exercises the zero padding)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(300, d)).astype(np.float32)
    dsub = -(-d // m)
    cb = rng.normal(size=(m, 16, dsub)).astype(np.float32)
    jcb = jpq.PQCodebooks(jnp.asarray(cb), jnp.sum(jnp.asarray(cb) ** 2, -1))
    tcb = tpq.codebooks_from(_t(cb))
    jc = np.asarray(jpq.encode_pq(jcb, jnp.asarray(x)))
    tc = tpq.encode_pq(tcb, _t(x)).numpy()
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tpq.decode_pq(tcb, _t(tc)).numpy(),
                               np.asarray(jpq.decode_pq(jcb, jnp.asarray(jc))),
                               rtol=RTOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_flat_search(metric):
    """Brute-force fallback: same distances, penalty-masked rows never
    returned, score range fused."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(500, 16)).astype(np.float32)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    pen = np.where(rng.random(500) < 0.2, BIG, 0.0).astype(np.float32)
    norms = (x ** 2).sum(1)
    for dr in (None, np.array([-1e9, 30.0], np.float32)):
        jdst, _ = jf.flat_search(jnp.asarray(x), jnp.asarray(norms),
                                 jnp.asarray(q), jnp.asarray(pen),
                                 None if dr is None else jnp.asarray(dr),
                                 k=10, metric=metric, chunk=128)
        tdst, tid = tf.flat_search(_t(x), _t(norms), _t(q), _t(pen),
                                   None if dr is None else _t(dr),
                                   k=10, metric=metric, chunk=128)
        np.testing.assert_allclose(tdst.numpy(), np.asarray(jdst),
                                   rtol=RTOL, atol=1e-4)
        ids = tid.numpy()
        live = tdst.numpy() < BIG
        assert np.all(pen[ids[live]] == 0.0)
