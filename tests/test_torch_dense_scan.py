"""Parity of the port's dense scan (gamma_tpu_torch/ops/dense_scan.py)
with the JAX package's (gamma_tpu/ops/dense_scan.py) on the same inputs:
a bf16 reconstruction mirror with norms taken from its stored rows, the
bias or penalty, the bf16 store mirror the rerank reads, and queries,
all made with numpy from a local seed.

Both metrics, rerank on and off, a score range, a live watermark below
the row count and the tiled select are covered.  Tolerances: with the
rerank the top-k distances are exact f32 distances of the chosen rows,
so they agree within rtol 1e-5 / atol 1e-4; without it they are the
selection scores, whose bf16 x bf16 products the two sides sum in
another order, so rtol 1e-3.  Near-ties may pick different ids, so the
distances of each side's chosen ids are compared, sorted."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.ops import dense_scan as jds
from gamma_tpu_torch.ops import dense_scan as tds

BIG = 3.0e38
N, D, B, K, R = 5000, 32, 16, 10, 100


def _inputs(seed, metric):
    """(recon bf16 [N, D], recon_norms, raw bf16 [N, D], queries [B, D])
    as numpy f32 arrays holding bf16 values where the type is bf16."""
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.normal(size=(40, D))
    x = centers[rng.integers(0, 40, N)] + 0.4 * rng.normal(size=(N, D))
    raw = np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    noisy = x + 0.05 * rng.normal(size=(N, D))        # the PQ error
    recon = np.asarray(jnp.asarray(noisy, jnp.float32).astype(jnp.bfloat16)
                       .astype(jnp.float32))
    norms = (recon.astype(np.float32) ** 2).sum(1).astype(np.float32)
    q = (x[rng.choice(N, B, replace=False)]
         + 0.2 * rng.normal(size=(B, D))).astype(np.float32)
    if metric == "ip":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return recon, norms, raw, q


def _penalty(seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(N) < 0.1, BIG, 0.0).astype(np.float32)


def _jax(x, dtype=None):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if dtype == "bf16" else a


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _agree(a, b, rerank):
    (da, ia), (db, ib) = a, b
    da, db = np.asarray(da), db.numpy()
    ia, ib = np.asarray(ia), ib.numpy()
    np.testing.assert_array_equal(ia < 0, ib < 0)
    live = ia >= 0
    if rerank:
        np.testing.assert_allclose(np.sort(db, 1)[live], np.sort(da, 1)[live],
                                   rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_allclose(np.sort(db, 1)[live], np.sort(da, 1)[live],
                                   rtol=1e-3, atol=1e-3)
    overlap = np.mean([len(set(x) & set(y)) / max(1, len(set(x) - {-1}))
                       for x, y in zip(ia, ib)])
    assert overlap >= 0.9, overlap


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("rerank", [True, False])
def test_fast_form_matches_jax(metric, rerank):
    """The unfiltered form: one bias operand, the watermark applied after
    the select (live_n 4000 of 5000 rows)."""
    recon, norms, raw, q = _inputs(0, metric)
    valid = _penalty(1)
    bias = valid if metric == "ip" else np.minimum(norms + valid, BIG)
    live_n = 4000
    a = jds.dense_scan_search_fast(
        _jax(recon, "bf16"), _jax(bias), _jax(q), _jax(q), _jax(raw, "bf16"),
        jnp.int32(live_n), recall_num=R, k=K, metric=metric, rerank=rerank)
    b = tds.dense_scan_search_fast(
        _torch(recon, "bf16"), _torch(bias), _torch(q), _torch(q),
        _torch(raw, "bf16"), live_n, recall_num=R, k=K, metric=metric,
        rerank=rerank)
    _agree(a, b, rerank)
    ib = b[1].numpy()
    assert (ib < live_n).all() and not np.isin(ib, np.flatnonzero(valid)).any()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("rerank", [True, False])
@pytest.mark.parametrize("ranged", [False, True])
def test_penalty_form_matches_jax(metric, rerank, ranged):
    """The filtered form: a vid-aligned penalty, and optionally a score
    range fused into the select and the rerank."""
    recon, norms, raw, q = _inputs(2, metric)
    pen = _penalty(3)
    if ranged:
        lo, hi = ((0.5, 6.0) if metric == "l2" else (-0.9, -0.2))
        rng_j, rng_t = jnp.asarray([lo, hi], jnp.float32), torch.tensor(
            [lo, hi])
    else:
        rng_j = rng_t = None
    a = jds.dense_scan_search(
        _jax(recon, "bf16"), _jax(norms), _jax(q), _jax(pen),
        _jax(raw, "bf16"), _jax(q), rng_j, recall_num=R, k=K, metric=metric,
        rerank=rerank)
    b = tds.dense_scan_search(
        _torch(recon, "bf16"), _torch(norms), _torch(q), _torch(pen),
        _torch(raw, "bf16"), _torch(q), rng_t, recall_num=R, k=K,
        metric=metric, rerank=rerank)
    _agree(a, b, rerank)
    d, ids = b[0].numpy(), b[1].numpy()
    assert not np.isin(ids, np.flatnonzero(pen)).any()
    if ranged:
        live = ids >= 0
        assert live.any() and np.all((d[live] >= lo) & (d[live] <= hi))


@pytest.mark.parametrize("form", ["fast", "penalty", "ranged"])
def test_tiled_select_equals_untiled(monkeypatch, form):
    """A small tile splits the 5000 rows into 4 tiles; the merged select
    returns what the whole [B, N] select does."""
    recon, norms, raw, q = _inputs(4, "l2")
    pen = _penalty(5)
    args = [_torch(recon, "bf16"), None, _torch(q), _torch(q),
            _torch(raw, "bf16")]

    def run():
        if form == "fast":
            return tds.dense_scan_search_fast(
                args[0], _torch(np.minimum(norms + pen, BIG)), args[2],
                args[3], args[4], N, recall_num=R, k=K, rerank=False)
        rng_t = torch.tensor([0.5, 8.0]) if form == "ranged" else None
        return tds.dense_scan_search(
            args[0], _torch(norms), args[2], _torch(pen), args[4], args[3],
            rng_t, recall_num=R, k=K, rerank=False)

    whole = run()
    seen = []
    tiles = tds._tiled_min_k

    def counting(score, n, b, r):
        seen.append(-(-n // tds._tile_rows(b, r)))
        return tiles(score, n, b, r)

    monkeypatch.setattr(tds, "_tiled_min_k", counting)
    monkeypatch.setattr(tds, "DENSE_TILE_BYTES", 4 * B * 1500)
    tiled = run()
    assert seen == [4]
    np.testing.assert_array_equal(tiled[0].numpy(), whole[0].numpy())
    np.testing.assert_array_equal(tiled[1].numpy(), whole[1].numpy())


def test_approx_min_k_pads_short_rows():
    """Fewer rows than k: (BIG, -1) padding, as the JAX helper gives."""
    dist = np.random.default_rng(6).random((3, 7)).astype(np.float32)
    jv, ji = jds._approx_min_k(jnp.asarray(dist), 10, 0.95)
    tv, ti = tds._approx_min_k(torch.from_numpy(dist), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_fewer_rows_than_recall_num():
    """A mirror smaller than recall_num (an index just trained): both
    sides pad the candidate pool and return the same rows."""
    recon, norms, raw, q = _inputs(7, "l2")
    n = 60
    pen = np.zeros(n, np.float32)
    a = jds.dense_scan_search(
        _jax(recon[:n], "bf16"), _jax(norms[:n]), _jax(q), _jax(pen),
        _jax(raw[:n], "bf16"), _jax(q), None, recall_num=R, k=K)
    b = tds.dense_scan_search(
        _torch(recon[:n], "bf16"), _torch(norms[:n]), _torch(q),
        _torch(pen), _torch(raw[:n], "bf16"), _torch(q), None,
        recall_num=R, k=K)
    _agree(a, b, True)
