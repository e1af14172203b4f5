"""Parity of the port's FLAT model (gamma_tpu_torch.index.flat) with the
JAX package's: the same store rows, queries, row-space penalty and score
range through both; distances to 1e-3 (both scan the bf16 store mirror
with a bf16 product of f32 queries rounded alike), same ids away from
ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.config import SearchParams as JSP
from gamma_tpu.index import create_model as jcreate
from gamma_tpu.vector.raw_store import RawVectorStore as JStore
from gamma_tpu_torch.config import SearchParams as TSP
from gamma_tpu_torch.index import create_model as tcreate
from gamma_tpu_torch.index.flat import FlatIndex
from gamma_tpu_torch.vector.raw_store import RawVectorStore as TStore

D = 24
BIG = 3.0e38


def _pair(n=700, seed=0, params=None):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, D)).astype(np.float32) * 2.0
    x = (centers[rng.integers(0, 12, n)]
         + 0.3 * rng.normal(size=(n, D))).astype(np.float32)
    q = (x[rng.choice(n, min(n, 9), replace=False)]
         + 0.05 * rng.normal(size=(min(n, 9), D))).astype(np.float32)
    js, ts = JStore("vec", D), TStore("vec", D, device="cpu")
    for s in (js, ts):
        s.add(x)
        s.flush_device()
    return (jcreate("FLAT", js, params), tcreate("FLAT", ts, params), x, q)


def _penalty(m, n, kill=()):
    p = np.full(m.store.device.shape[0], BIG, np.float32)
    p[:n] = 0.0
    p[list(kill)] = BIG
    return p


def _both(jm, tm, q, pen, k=10, sp=None, dist_range=None):
    jd, jr, jv = jm.search(
        jnp.asarray(q), jnp.asarray(pen), JSP.from_dict(sp), k,
        None if dist_range is None else jnp.asarray(dist_range, jnp.float32))
    td, tr, tv = tm.search(
        torch.from_numpy(q), torch.from_numpy(pen), TSP.from_dict(sp), k,
        None if dist_range is None else torch.tensor(dist_range))
    np.testing.assert_array_equal(tr.numpy(), tv.numpy())
    return (np.asarray(jd), np.asarray(jr)), (td.numpy(), tr.numpy())


def _agree(a, b):
    (da, ia), (db, ib) = a, b
    dead = da >= 1e37
    np.testing.assert_array_equal(db >= 1e37, dead)
    np.testing.assert_allclose(np.where(dead, 0, db), np.where(dead, 0, da),
                               rtol=1e-3, atol=1e-3)
    overlap = np.mean([len(set(x) & set(y)) / len(set(x))
                       for x, y in zip(ia, ib)])
    assert overlap >= 0.95, overlap


@pytest.mark.parametrize("metric", ["L2", "InnerProduct"])
def test_flat_search_matches_jax(metric):
    jm, tm, x, q = _pair(params={"metric_type": metric})
    assert isinstance(tm, FlatIndex) and tm.penalty_space == "row"
    assert tm.default_metric == type(tm.default_metric)(int(jm.default_metric))
    a, b = _both(jm, tm, q, _penalty(tm, x.shape[0]))
    _agree(a, b)
    if metric == "L2":
        d, rows = tm.search(torch.from_numpy(x[:50]),
                            torch.from_numpy(_penalty(tm, x.shape[0])),
                            TSP(), 1)[:2]
        assert (rows[:, 0].numpy() == np.arange(50)).mean() >= 0.98


def test_flat_request_metric_overrides_default():
    jm, tm, x, q = _pair(seed=1)
    a, b = _both(jm, tm, q, _penalty(tm, x.shape[0]),
                 sp={"metric_type": "InnerProduct"})
    _agree(a, b)
    assert (b[0] < 0).any()         # IP scores are negated


def test_flat_row_penalty_and_score_range():
    jm, tm, x, q = _pair(seed=2)
    kill = range(0, x.shape[0], 2)
    pen = _penalty(tm, x.shape[0], kill)
    a, b = _both(jm, tm, q, pen)
    _agree(a, b)
    assert (b[1][b[1] >= 0] % 2 == 1).all()
    base = np.sort(b[0].ravel())

    def mid(i):
        """The middle of the widest gap near sorted value i: a bound no
        distance sits on, whichever framework rounded it."""
        j = max(range(i - 4, i + 4), key=lambda t: base[t + 1] - base[t])
        return float(base[j] + base[j + 1]) / 2.0

    lo, hi = mid(len(base) // 4), mid(3 * len(base) // 4)
    a, b = _both(jm, tm, q, pen, dist_range=(lo, hi))
    _agree(a, b)
    live = b[0] < 1e37
    assert live.any() and (b[0][live] >= lo).all() and (b[0][live] <= hi).all()


def test_flat_k_past_live_rows_pads():
    jm, tm, x, q = _pair(n=6, seed=3)
    a, b = _both(jm, tm, q[:2], _penalty(tm, 6), k=10)
    _agree(a, b)
    assert (b[0][:, 6:] >= 1e37).all()


def test_flat_lifecycle_is_the_stores():
    """Nothing to train, add or dump: the store mirror is the index."""
    jm, tm, x, _ = _pair(seed=4)
    assert tm.trained() and jm.trained()
    tm.train(x)
    tm.add(x, np.arange(3), np.arange(3))
    jm.add(x, np.arange(3), np.arange(3))
    assert tm.indexed_count == jm.indexed_count == x.shape[0]
    tm.delete(np.arange(3))
    tm.dump("/nonexistent")          # writes nothing
    tm.indexed_count = 0
    assert tm.load("/nonexistent") == jm.load("/nonexistent") == x.shape[0]
    assert tm.mem_bytes() == jm.mem_bytes() == 0
