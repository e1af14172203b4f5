"""Parity of the port's gather searches (gamma_tpu_torch.ops.ivf_scan)
with the JAX package's ivfsq_search and ivfpq_search on the same numpy
state.

The JAX side runs its TPU path (scan_impl="pallas": the grouped scan,
folded at cap >= 4096) with the Pallas kernels in interpret mode, so both
sides round the query operand to bf16 alike.  Near-ties may still pick
different ids, so the comparison is on the exact distances (float64, to
the dequantized points) of the ids each side chose, sorted per query, to
1e-3 relative (ROADMAP rule)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.ops import ivf_scan as jiv
from gamma_tpu.ops import pallas_adc as jadc
from gamma_tpu.ops import pallas_gadc as jgadc
from gamma_tpu.ops import pallas_gsq as jgsq
from gamma_tpu.ops import pq as jpq
from gamma_tpu_torch.ops import pq as tpq
from gamma_tpu.realtime.invert_index import IVFState as JState
from gamma_tpu_torch.ops import gsq as ts
from gamma_tpu_torch.ops import ivf_scan as tiv
from gamma_tpu_torch.realtime.invert_index import IVFState as TState

BIG = 3.0e38


@pytest.fixture
def jax_scan(monkeypatch):
    """JAX ivfsq_search on its TPU code path, kernels interpreted."""
    monkeypatch.setattr(jgsq, "grouped_sq_scan", functools.partial(
        jgsq.grouped_sq_scan, interpret=True))
    return functools.partial(jiv.ivfsq_search, scan_impl="pallas")


def _t(a):
    return torch.from_numpy(np.array(a))


class _World:
    """One SQ8 posting state in numpy, as both packages see it."""

    def __init__(self, seed, nlist=12, cap=64, d=24, fill=0.8):
        rng = np.random.default_rng(seed)
        d_pad = 128
        self.cents = (rng.normal(size=(nlist, d)) * 3.0).astype(np.float32)
        lens = rng.integers(int(cap * fill * 0.5), int(cap * fill) + 1,
                            size=nlist).astype(np.int32)
        rows = (self.cents[:, None, :]
                + 0.3 * rng.normal(size=(nlist, cap, d))).astype(np.float32)
        scale, off = ts.train_sq(_t((rows - self.cents[:, None]).reshape(
            -1, d)))
        codes, norms = ts.encode_sq(_t(rows.reshape(-1, d)), scale, off,
                                    _t(np.repeat(self.cents, cap, 0)),
                                    d_pad=d_pad, residual=True)
        self.codes = codes.numpy().reshape(nlist, cap, d_pad)
        self.norms = norms.numpy().reshape(nlist, cap)
        self.scale, self.off = scale.numpy(), off.numpy()
        live = np.arange(cap)[None, :] < lens[:, None]
        ids = np.full((nlist, cap), -1, np.int32)
        ids[live] = rng.permutation(int(live.sum()))
        dead = live & (rng.random((nlist, cap)) < 0.05)   # tombstones
        self.vids = np.where(dead, -1, ids).astype(np.int32)
        self.docids = self.vids.copy()
        self.lens = lens
        self.n = int(live.sum())
        # exact dequantized point per docid (the oracle's corpus)
        deq = (self.cents[:, None, :] + self.off
               + self.scale * self.codes[..., :d].astype(np.float64))
        self.points = np.zeros((self.n, d))
        self.points[ids[live]] = deq[live]
        self.rows = np.zeros((self.n, d), np.float32)
        self.rows[ids[live]] = rows[live]
        pick = rng.choice(np.flatnonzero(self.docids.reshape(-1) >= 0), 6,
                          replace=False)
        self.queries = (rows.reshape(-1, d)[pick]
                        + 0.1 * rng.normal(size=(6, d))).astype(np.float32)
        self.penalty = np.where(rng.random(self.n + 7) < 0.2, BIG,
                                0.0).astype(np.float32)
        self.nlist = nlist
        self.rng = rng

    def rng_choice(self, p):
        return self.rng.choice(self.nlist, p, replace=False)

    def args(self, torch_side):
        if torch_side:
            st = TState(_t(np.zeros(self.codes.shape[:2] + (4,), np.uint8)),
                        _t(self.vids), _t(self.docids), _t(self.lens))
            f = _t
        else:
            st = JState(jnp.zeros(self.codes.shape[:2] + (4,), jnp.uint8),
                        jnp.asarray(self.vids), jnp.asarray(self.docids),
                        jnp.asarray(self.lens))
            f = jnp.asarray
        cn = (self.cents.astype(np.float32) ** 2).sum(1)
        return (st, f(self.codes), f(self.norms), f(self.scale),
                f(self.off), f(self.cents), f(cn), f(self.queries),
                f(self.penalty))

    def exact(self, ids, metric):
        q = self.queries.astype(np.float64)[:, None, :]
        p = self.points[np.maximum(ids, 0)]
        d = -(q * p).sum(-1) if metric == "ip" else ((q - p) ** 2).sum(-1)
        return np.where(ids >= 0, d, np.inf)


def _compare(world, jout, tout, metric, k):
    jd, jdoc = np.asarray(jout[0]), np.asarray(jout[1])
    td, tdoc = tout[0].numpy(), tout[1].numpy()
    assert td.shape == (world.queries.shape[0], k)
    # the port's distances are its ids' distances (bf16 cross term)
    ex_t = world.exact(tdoc, metric)
    live = tdoc >= 0
    np.testing.assert_array_equal(live, td < 1e37)
    scale = np.abs(world.exact(jdoc, metric)[jdoc >= 0]).mean() + 1.0
    assert np.abs(ex_t[live] - td[live]).max(initial=0) <= 0.05 * scale
    # both sides chose equally good ids
    ej = np.sort(world.exact(jdoc, metric), 1)
    et = np.sort(ex_t, 1)
    both = np.isfinite(ej) & np.isfinite(et)
    np.testing.assert_array_equal(np.isfinite(ej), np.isfinite(et))
    np.testing.assert_allclose(et[both], ej[both], rtol=1e-3,
                               atol=1e-3 * scale)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("mode", ["validity", "penalty", "range"])
def test_ivfsq_search_matches_jax(jax_scan, metric, mode):
    w = _World(seed=11)
    k = 5
    kw = dict(nprobe=4, k=k, metric=metric, cap_eff=48)
    extra_j, extra_t = [None, None], [None, None]     # dist_range, live_n
    if mode == "validity":
        extra_j[1] = jnp.int32(w.n - 5)
        extra_t[1] = w.n - 5
    if mode == "range":
        lo, hi = (0.5, 40.0) if metric == "l2" else (-30.0, -3.0)
        extra_j[0] = jnp.asarray([lo, hi], jnp.float32)
        extra_t[0] = torch.tensor([lo, hi])
    jout = jax_scan(*w.args(False), *extra_j, **kw)
    tout = tiv.ivfsq_search(*w.args(True), *extra_t, **kw)
    _compare(w, jout, tout, metric, k)
    if mode == "range":
        td = tout[0].numpy()
        ok = td < 1e37
        assert np.all((td[ok] >= lo - 0.1) & (td[ok] <= hi + 0.1))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ivfsq_fold_path_matches_jax(jax_scan, metric):
    """cap_eff >= 4096 routes both sides through the folded scan (B2)."""
    w = _World(seed=12, nlist=4, cap=4096, d=8, fill=0.9)
    k = 8
    kw = dict(nprobe=2, k=k, metric=metric, cap_eff=4096)
    jout = jax_scan(*w.args(False), None, jnp.int32(w.n), **kw)
    tout = tiv.ivfsq_search(*w.args(True), None, w.n, **kw)
    _compare(w, jout, tout, metric, k)


def test_ivfsq_sq_rerank_matches_jax(jax_scan):
    """sp.sq_rerank: exact rerank of the SQ8 candidates against raw rows
    returns the rows' exact f32 distances on both sides."""
    w = _World(seed=13)
    k = 5
    kw = dict(nprobe=4, k=k, metric="l2", cap_eff=64, recall_num=20,
              rerank=True)
    jout = jax_scan(*w.args(False), None, jnp.int32(w.n),
                    jnp.asarray(w.rows), jnp.asarray(w.queries), **kw)
    tout = tiv.ivfsq_search(*w.args(True), None, w.n, _t(w.rows),
                            _t(w.queries), **kw)
    np.testing.assert_allclose(np.sort(tout[0].numpy(), 1),
                               np.sort(np.asarray(jout[0]), 1), rtol=1e-5,
                               atol=1e-5)


def test_chunkmin_topk_exact_and_matches_jax():
    """The strided chunk-min select returns the exact top-k when the
    winners sit in distinct bins, and the same values as the JAX op."""
    rng = np.random.default_rng(14)
    b, width, rn = 3, 40000, 10
    flat = rng.random((b, width)).astype(np.float32)
    got_v, got_i = tiv._chunkmin_topk(_t(flat), rn)
    exact = np.sort(flat, 1)[:, :rn]
    np.testing.assert_array_equal(got_v.numpy(), exact)
    np.testing.assert_array_equal(
        np.take_along_axis(flat, got_i.numpy(), 1), got_v.numpy())
    jv, _ = jiv._chunkmin_topk(jnp.asarray(flat), rn)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_plain_oracle_matches_xla_twin(metric):
    """sq_raw_dist_plain (the port's plain oracle) equals the JAX XLA
    twin in f32, and the grouped scan stays within the bf16 operand's
    error class of it on in-length slots (tests/test_pallas_gsq.py's
    2e-2 element-wise bound, median floor)."""
    w = _World(seed=15)
    li = np.stack([w.rng_choice(4) for _ in range(6)]).astype(np.int64)
    args = (w.codes, w.norms, w.scale, w.off, w.cents)
    ref = np.asarray(jiv.sq_raw_dist_xla(
        *map(jnp.asarray, args), jnp.asarray(li), jnp.asarray(w.queries),
        metric=metric))
    got = tiv.sq_raw_dist_plain(*map(_t, args), _t(li), _t(w.queries),
                                metric=metric).numpy()
    live = np.arange(w.codes.shape[1])[None, None, :] < w.lens[li][..., None]
    floor = max(float(np.median(np.abs(ref[live]))), 1e-6)
    assert (np.abs(got - ref)[live] / np.maximum(np.abs(ref[live]), floor)
            ).max() < 1e-5
    grouped = ts.grouped_sq_scan(
        _t(w.codes), _t(w.norms), _t(w.lens), _t(li), _t(w.queries),
        _t(w.scale), _t(w.off), _t(w.cents), metric=metric).numpy()
    assert (np.abs(grouped - got)[live] / np.maximum(np.abs(got[live]), floor)
            ).max() < 2e-2


@pytest.fixture
def jax_adc_scan(monkeypatch):
    """JAX ivfpq_search on its TPU code path, kernels interpreted."""
    monkeypatch.setattr(jgadc, "grouped_adc", functools.partial(
        jgadc.grouped_adc, interpret=True))
    monkeypatch.setattr(jadc, "adc_scan_pallas", functools.partial(
        jadc.adc_scan_pallas, interpret=True))
    return functools.partial(jiv.ivfpq_search, scan_impl="pallas")


@pytest.mark.parametrize("m", [8, 6])            # M*ksub 128 → B3, 96 → B4
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("mode", ["validity", "range", "rerank"])
def test_ivfpq_search_matches_jax(jax_adc_scan, m, metric, mode):
    """ADC search over PQ codes: the port's B3/B4 dispatch against the JAX
    package's, on one posting state; the chosen ids are judged by their
    exact distances to the reconstructed points (the rerank rows)."""
    rng = np.random.default_rng(16)
    nlist, cap, d, ksub, b, k = 12, 64, 24, 16, 6, 5
    dsub = -(-d // m)
    cb = rng.normal(size=(m, ksub, dsub)).astype(np.float32) * 0.3
    cents = (rng.normal(size=(nlist, d)) * 3.0).astype(np.float32)
    codes = rng.integers(0, ksub, (nlist, cap, m)).astype(np.uint8)
    lens = rng.integers(cap // 2, cap + 1, nlist).astype(np.int32)
    live = np.arange(cap)[None, :] < lens[:, None]
    ids = np.full((nlist, cap), -1, np.int32)
    n = int(live.sum())
    ids[live] = rng.permutation(n)
    vids = np.where(live & (rng.random((nlist, cap)) < 0.05), -1, ids)
    rec = (cents[:, None, :] + cb[np.arange(m), codes].reshape(
        nlist, cap, m * dsub)[..., :d]).astype(np.float32)
    rows = np.zeros((n, d), np.float32)
    rows[ids[live]] = rec[live]
    q = (rows[rng.choice(n, b, replace=False)]
         + 0.2 * rng.normal(size=(b, d))).astype(np.float32)
    pen = np.zeros(n + 3, np.float32)
    jcb = jpq.PQCodebooks(jnp.asarray(cb), jnp.asarray((cb * cb).sum(-1)))
    tcb = tpq.codebooks_from(_t(cb))
    kw = dict(nprobe=4, recall_num=20, k=k, metric=metric,
              rerank=mode == "rerank", cap_eff=64)
    dr = None
    if mode == "range":
        dr = (1.0, 30.0) if metric == "l2" else (-60.0, -5.0)
    cn = (cents ** 2).sum(1)
    jout = jax_adc_scan(
        JState(jnp.asarray(codes), jnp.asarray(vids), jnp.asarray(vids),
               jnp.asarray(lens)), jnp.asarray(cents), jnp.asarray(cn), jcb,
        jnp.asarray(q), jnp.asarray(pen), jnp.asarray(rows), None,
        None if dr is None else jnp.asarray(dr, jnp.float32),
        None if mode == "range" else jnp.int32(n), **kw)
    tout = tiv.ivfpq_search(
        TState(_t(codes), _t(vids), _t(vids), _t(lens)), _t(cents), _t(cn),
        tcb, _t(q), _t(pen), _t(rows), None,
        None if dr is None else torch.tensor(dr),
        None if mode == "range" else n, **kw)

    def exact(doc):
        p = rows[np.maximum(doc, 0)].astype(np.float64)
        qq = q[:, None, :].astype(np.float64)
        e = -(qq * p).sum(-1) if metric == "ip" else ((qq - p) ** 2).sum(-1)
        return np.where(doc >= 0, e, np.inf)

    tdoc = tout[1].numpy()
    assert tout[0].shape == (b, k) and (tdoc >= 0).any()
    ej, et = np.sort(exact(np.asarray(jout[1])), 1), np.sort(exact(tdoc), 1)
    np.testing.assert_array_equal(np.isfinite(et), np.isfinite(ej))
    ok = np.isfinite(ej)
    np.testing.assert_allclose(et[ok], ej[ok], rtol=1e-3, atol=1e-3)
    # the returned distances are those of the chosen ids (ADC distances
    # equal exact distances to the reconstruction, up to the bf16 LUT)
    td = tout[0].numpy()
    np.testing.assert_allclose(td[tdoc >= 0], exact(tdoc)[tdoc >= 0],
                               rtol=2e-2, atol=0.05)
    if mode == "range":
        got = td[tdoc >= 0]
        assert np.all((got >= dr[0] - 0.05) & (got <= dr[1] + 0.05))
