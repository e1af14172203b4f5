"""Parity of the port's IVFFLAT model and its search
(gamma_tpu_torch.ops.ivf_scan.ivfflat_search, gamma_tpu_torch.index.ivfflat)
with the JAX package's, on the same numpy inputs.

The search's two forms against their JAX counterparts: the per-query
gather form against scan_impl="xla" (both exact f32 distances to the
stored bf16 rows: 1e-5 relative, same ids away from ties), the grouped
form against scan_impl="pallas" with the kernel interpreted (both round
the query to bf16 for the product: the distances of each side's chosen
ids are compared, not id sets).  The model against the JAX class with
the centroids carried across, and through the shared `.ivfflat.npz` dump
both ways (gamma_tpu_torch.convert)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.config import SearchParams as JSP
from gamma_tpu.index.ivfflat import IVFFlatIndex as JIndex
from gamma_tpu.ops import ivf_scan as jscan
from gamma_tpu.ops import pallas_gsq as jgsq
from gamma_tpu.realtime import invert_index as jrt
from gamma_tpu.vector.raw_store import RawVectorStore as JStore
from gamma_tpu_torch import convert
from gamma_tpu_torch.config import SearchParams as TSP
from gamma_tpu_torch.index.ivfflat import IVFFlatIndex as TIndex
from gamma_tpu_torch.index.ivfflat import _to_bf16_bytes
from gamma_tpu_torch.ops import ivf_scan as tscan
from gamma_tpu_torch.realtime import invert_index as trt
from gamma_tpu_torch.vector.raw_store import RawVectorStore as TStore

D = 32
BIG = 3.0e38
PARAMS = {"ncentroids": 16, "nprobe": 6, "bucket_init_size": 64}


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX grouped scan with its kernel interpreted (and the JAX
    model on its TPU dispatch)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jgsq, "grouped_sq_scan", functools.partial(
        jgsq.grouped_sq_scan, interpret=True))


def _posting(seed, nlist=16, cap=24, d=D, n=300):
    """A posting state built by hand (numpy): rows placed in their
    nearest list, bf16 bytes as payload, a few tombstones.
    → (codes u8, vids, docids, lens, cents, rows)."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    cents = rng.normal(size=(nlist, d)).astype(np.float32) * 2.0
    la = np.argmin(((rows[:, None, :] - cents[None]) ** 2).sum(-1), axis=1)
    by = _to_bf16_bytes(torch.from_numpy(rows)).numpy()
    codes = np.zeros((nlist, cap, d * 2), np.uint8)
    vids = np.full((nlist, cap), -1, np.int32)
    lens = np.zeros(nlist, np.int32)
    for i in range(n):
        li = la[i]
        if lens[li] >= cap:
            continue
        codes[li, lens[li]] = by[i]
        vids[li, lens[li]] = i
        lens[li] += 1
    docids = vids.copy()
    dead = rng.choice(n, 10, replace=False)
    kill = np.isin(vids, dead)
    vids[kill] = -1
    docids[kill] = -1
    return codes, vids, docids, lens, cents, rows


def _states(codes, vids, docids, lens):
    return (jrt.IVFState(*(jnp.asarray(a) for a in
                           (codes, vids, docids, lens))),
            trt.IVFState(*(torch.from_numpy(a) for a in
                           (codes, vids, docids, lens))))


def _run_both(seed, metric, impl, *, penalty=None, dist_range=None,
              cap_eff=0, d=D):
    codes, vids, docids, lens, cents, rows = _posting(seed, d=d)
    n = rows.shape[0]
    rng = np.random.default_rng(seed + 100)
    q = (rows[rng.integers(0, n, size=7)]
         + 0.05 * rng.normal(size=(7, d))).astype(np.float32)
    pen = np.zeros(n + 8, np.float32) if penalty is None else penalty(n)
    js, ts = _states(codes, vids, docids, lens)
    kw = dict(nprobe=6, k=8, d=d, metric=metric, cap_eff=cap_eff)
    jd, jdoc, jvid = jscan.ivfflat_search(
        js, jnp.asarray(cents), jnp.sum(jnp.asarray(cents) ** 2, -1),
        jnp.asarray(q), jnp.asarray(pen),
        None if dist_range is None else jnp.asarray(dist_range, jnp.float32),
        scan_impl={"gather": "xla", "grouped": "pallas"}[impl], **kw)
    ct = torch.from_numpy(cents)
    td, tdoc, tvid = tscan.ivfflat_search(
        ts, ct, (ct * ct).sum(-1), torch.from_numpy(q),
        torch.from_numpy(pen),
        None if dist_range is None else torch.tensor(dist_range),
        scan_impl=impl, **kw)
    return ((np.asarray(jd), np.asarray(jdoc), np.asarray(jvid)),
            (td.numpy(), tdoc.numpy(), tvid.numpy()), q, rows, pen)


def _exact(q, rows, ids, metric):
    """Distances of chosen ids to the stored (bf16-rounded) rows."""
    r = torch.from_numpy(rows).to(torch.bfloat16).float().numpy()[ids]
    if metric == "ip":
        return -(q[:, None, :] * r).sum(-1)
    return ((q[:, None, :] - r) ** 2).sum(-1)


def _same(j, t, rtol, atol):
    """Sorted distances agree; ids agree except where the next distance
    is a near-tie; dead slots are (-1, -1) on both sides."""
    (jd, jdoc, jvid), (td, tdoc, tvid) = j, t
    dead = jd >= 1e37
    np.testing.assert_array_equal(td >= 1e37, dead)
    np.testing.assert_allclose(np.where(dead, 0, td), np.where(dead, 0, jd),
                               rtol=rtol, atol=atol)
    assert (tdoc[dead] == -1).all() and (tvid[dead] == -1).all()
    agree = np.mean([len(set(a) & set(b)) / len(set(a))
                     for a, b in zip(jdoc, tdoc)])
    assert agree >= 0.95, agree
    np.testing.assert_array_equal(tdoc, tvid)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gather_form_matches_xla(metric):
    """Per-query exact scan: 1e-5 relative, same ids, and the distances
    are the exact ones to the stored bf16 rows."""
    j, t, q, rows, _ = _run_both(1, metric, "gather")
    _same(j, t, 1e-5, 1e-5)
    np.testing.assert_array_equal(t[1], j[1])
    live = t[0] < 1e37
    ex = _exact(q, rows, np.maximum(t[1], 0), metric)
    np.testing.assert_allclose(t[0][live], ex[live], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_grouped_form_matches_pallas(metric, jax_pallas):
    """Grouped scan against the interpreted kernel: both round the query
    to bf16, so the sorted distances agree to 1e-4 of their magnitude;
    each side's chosen ids are within the bf16 query blur (3e-2, the
    JAX package's own bar) of the exact distances."""
    j, t, q, rows, _ = _run_both(2, metric, "grouped")
    scale = max(float(np.median(np.abs(j[0][j[0] < 1e37]))), 1.0)
    _same(j, t, 1e-4, 1e-4 * scale)
    for d, doc, _ in (j, t):
        live = d < 1e37
        ex = _exact(q, rows, np.maximum(doc, 0), metric)
        floor = max(float(np.median(np.abs(ex[live]))), 1e-6)
        assert (np.abs(d - ex)[live]
                / np.maximum(np.abs(ex[live]), floor)).max() < 3e-2


@pytest.mark.parametrize("impl", ["gather", "grouped"])
def test_forms_agree_with_each_other(impl, jax_pallas):
    """The port's two forms return the same neighbours (ids may flip on
    bf16 near-ties: 7 of 8 a query, as tests/test_pallas_gsq.py asks)."""
    _, ta, *_ = _run_both(3, "l2", "gather")
    _, tb, *_ = _run_both(3, "l2", impl)
    for a, b in zip(ta[1], tb[1]):
        assert len(set(a) & set(b)) >= 7


@pytest.mark.parametrize("impl", ["gather", "grouped"])
def test_penalty_and_score_range(impl, jax_pallas):
    """A doc-space penalty (every third doc filtered) and a fused score
    range: nothing filtered or out of range comes back, on either side,
    and both sides agree."""
    def pen(n):
        p = np.zeros(n + 8, np.float32)
        p[::3] = BIG
        return p
    tol = 1e-5 if impl == "gather" else 1e-3
    j, t, *_ = _run_both(4, "l2", impl, penalty=pen)
    _same(j, t, tol, tol * 10)
    assert (t[1][t[1] >= 0] % 3 != 0).all()
    base = np.sort(t[0][t[0] < 1e37])
    lo, hi = float(base[len(base) // 4]), float(base[3 * len(base) // 4])
    j, t, *_ = _run_both(4, "l2", impl, penalty=pen, dist_range=(lo, hi))
    _same(j, t, tol, tol * 10)
    live = t[0] < 1e37
    assert live.any() and (t[0][live] >= lo).all() and (t[0][live] <= hi).all()
    assert (t[1][live] % 3 != 0).all()


@pytest.mark.parametrize("impl", ["gather", "grouped"])
def test_cap_eff_trim_and_odd_width(impl, jax_pallas):
    """A scan trimmed to the live watermark (a strided view of the
    payload) and a d that is no multiple of 16 (the grouped form pads the
    rows to the kernel's k-step) change nothing."""
    tol = 1e-5 if impl == "gather" else 1e-3
    full = _run_both(5, "l2", impl)
    codes, vids, docids, lens, *_ = _posting(5)
    trim = _run_both(5, "l2", impl, cap_eff=int(lens.max()))
    np.testing.assert_allclose(trim[1][0], full[1][0], rtol=1e-6)
    np.testing.assert_array_equal(trim[1][1], full[1][1])
    j, t, *_ = _run_both(6, "l2", impl, d=20)
    _same(j, t, tol, tol * 10)


def test_ivfflat_search_rejects_unknown_form():
    codes, vids, docids, lens, cents, _ = _posting(7)
    _, ts = _states(codes, vids, docids, lens)
    ct = torch.from_numpy(cents)
    with pytest.raises(ValueError, match="grouped"):
        tscan.ivfflat_search(ts, ct, (ct * ct).sum(-1), torch.zeros((1, D)),
                             torch.zeros(400), nprobe=2, k=3, d=D,
                             scan_impl="pallas")


# ---------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------

def _corpus(seed, n=3000):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(24, D)).astype(np.float32) * 2.0
    x = (centers[rng.integers(0, 24, n)]
         + 0.3 * rng.normal(size=(n, D))).astype(np.float32)
    q = (x[rng.choice(n, 20, replace=False)]
         + 0.1 * rng.normal(size=(20, D))).astype(np.float32)
    return x, q


def _stores(x):
    js, ts = JStore("vec", D), TStore("vec", D, device="cpu")
    for s in (js, ts):
        s.add(x)
        s.flush_device()
    return js, ts


def _pair(x, n_train=2000, params=PARAMS):
    """A JAX model trained on x, and the port's with its centroids
    carried across (two k-means runs draw different seeds)."""
    js, ts = _stores(x)
    jm, tm = JIndex(js, params), TIndex(ts, params)
    jm.train(x[:n_train])
    tm.centroids = torch.from_numpy(np.array(jm.centroids))
    tm.cent_norms = (tm.centroids ** 2).sum(-1)
    tm._trained = True
    return jm, tm


def _search_j(m, q, k=10, sp=None, pen=None, dist_range=None):
    pen = jnp.zeros(m.store.n + 64, jnp.float32) if pen is None else pen
    d, doc, _ = m.search(
        jnp.asarray(q), pen, JSP.from_dict(sp), k,
        None if dist_range is None else jnp.asarray(dist_range, jnp.float32))
    return np.asarray(d), np.asarray(doc)


def _search_t(m, q, k=10, sp=None, pen=None, dist_range=None):
    pen = torch.zeros(m.store.n + 64) if pen is None else pen
    d, doc, _ = m.search(
        torch.from_numpy(q), pen, TSP.from_dict(sp), k,
        None if dist_range is None else torch.tensor(dist_range))
    return d.numpy(), doc.numpy()


def _agree(a, b, rtol=1e-3):
    (da, ia), (db, ib) = a, b
    np.testing.assert_allclose(np.sort(db, 1), np.sort(da, 1), rtol=rtol,
                               atol=rtol)
    overlap = np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(ia, ib)])
    assert overlap >= 0.95, overlap


def _lists(state):
    lens = np.asarray(state.lens)
    docs = np.asarray(state.docids)
    vids = np.asarray(state.vids)
    codes = np.asarray(state.codes)
    out = []
    for i in range(lens.size):
        live = docs[i, :lens[i]] >= 0
        out.append({int(v): codes[i, s].tobytes()
                    for s, v in enumerate(vids[i, :lens[i]]) if live[s]})
    return lens, out


def test_train_clamps_and_trains():
    """The port's own training: nlist centroids, every row assigned, and
    the clamp to nlist*256 rows draws the JAX package's subset."""
    x, q = _corpus(10)
    _, ts = _stores(x)
    tm = TIndex(ts, {"ncentroids": 8})
    assert not tm.trained()
    tm.train(x)            # 3000 > 8 * 256: clamped
    assert tm.trained() and tuple(tm.centroids.shape) == (8, D)
    ids = np.arange(3000)
    tm.add(x, ids, ids)
    assert int(tm.state.lens.sum()) == 3000 and tm.indexed_count == 3000
    d, doc = _search_t(tm, x[:50], k=1, sp={"nprobe": 8})
    assert (doc[:, 0] == np.arange(50)).mean() >= 0.98


def test_untrained_falls_back_to_flat():
    x, q = _corpus(11, n=500)
    js, ts = _stores(x)
    jm, tm = JIndex(js, PARAMS), TIndex(ts, PARAMS)
    pj = jnp.zeros(js.device.shape[0], jnp.float32).at[500:].set(BIG)
    pt = torch.zeros(ts.device.shape[0])
    pt[500:] = BIG
    _agree(_search_j(jm, q, pen=pj), _search_t(tm, q, pen=pt))
    # a penalty shorter than the mirror is padded with BIG
    d, doc = _search_t(tm, q, pen=torch.zeros(500))
    assert doc.max() < 500 and doc.min() >= 0


@pytest.mark.parametrize("impl", ["gather", "grouped"])
def test_model_add_search_delete_compact_grow(impl, jax_pallas,
                                              monkeypatch):
    """The same ingest (three batches, the lists outgrow their first
    capacity), deletes and compaction on both models: identical lens,
    per-list vids and payload bytes after every step, and the same
    answers."""
    if impl == "gather":
        # the JAX model off its TPU dispatch: scan_impl="xla"
        monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    x, q = _corpus(12)
    jm, tm = _pair(x, params=dict(PARAMS, scan_impl=impl))
    cap0 = tm.state.cap
    for s in range(0, 3000, 1000):
        ids = np.arange(s, s + 1000)
        jm.add(x[s:s + 1000], ids, ids)
        tm.add(x[s:s + 1000], ids, ids)
    assert tm.state.cap > cap0 and tm.state.cap == jm.state.cap
    assert tm._max_len == jm._max_len and tm.indexed_count == 3000

    def same_state():
        jl, jsets = _lists(jm.state)
        tl, tsets = _lists(tm.state)
        np.testing.assert_array_equal(tl, jl)
        assert tsets == jsets

    same_state()
    tol = 1e-5 if impl == "gather" else 1e-3
    _agree(_search_j(jm, q), _search_t(tm, q), tol)
    d, doc = _search_t(tm, x[:100], k=1)
    assert (doc[:, 0] == np.arange(100)).mean() >= 0.97

    dead = np.arange(0, 3000, 2)
    jm.delete(dead)
    tm.delete(dead)
    same_state()
    _, doc = _search_t(tm, q)
    assert (doc[doc >= 0] % 2 == 1).all()
    _agree(_search_j(jm, q), _search_t(tm, q), tol)
    jm.compact()
    tm.compact()
    assert int(tm.state.lens.sum()) == 1500
    assert tm._max_len == jm._max_len
    same_state()
    _agree(_search_j(jm, q), _search_t(tm, q), tol)
    # an update: tombstone and re-add under the same vid
    upd = np.array([1, 3, 5])
    jm.update(upd, x[upd] + 1.0, upd)
    tm.update(upd, x[upd] + 1.0, upd)
    same_state()
    assert tm.indexed_count == 3000
    assert tm.mem_bytes() == jm.mem_bytes()


def test_dump_cross_load_both_ways(tmp_path, jax_pallas):
    """A JAX `.ivfflat.npz` loads in the port and a port dump in JAX;
    all four models answer alike and ingest alike afterwards."""
    x, q = _corpus(13)
    jm, tm0 = _pair(x)
    ids = np.arange(2500)
    jm.add(x[:2500], ids, ids)
    jm.delete(np.arange(0, 50))
    jm.dump(str(tmp_path / "j"))

    _, ts = _stores(x)
    tm = TIndex(ts, PARAMS)
    assert tm.load(str(tmp_path / "j")) == 2500
    assert tm.trained() and tm._max_len == jm._max_len
    _agree(_search_j(jm, q), _search_t(tm, q))

    tm.dump(str(tmp_path / "t"))
    with np.load(str(tmp_path / "t" / "vec.ivfflat.npz")) as zt, \
            np.load(str(tmp_path / "j" / "vec.ivfflat.npz")) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for key in zj.files:
            np.testing.assert_array_equal(zt[key], zj[key])
    js2, _ = _stores(x)
    jm2 = JIndex(js2, PARAMS)
    assert jm2.load(str(tmp_path / "t")) == 2500
    _agree(_search_j(jm2, q), _search_t(tm, q))

    more = np.arange(2500, 3000)
    jm2.add(x[2500:], more, more)
    tm.add(x[2500:], more, more)
    jl, jsets = _lists(jm2.state)
    tl, tsets = _lists(tm.state)
    np.testing.assert_array_equal(tl, jl)
    assert tsets == jsets
    # deleting a doc the dump held works through the rebuilt vid map
    tm.delete(np.array([60]))
    _, doc = _search_t(tm, x[60:61])
    assert 60 not in doc


def test_untrained_dump_and_missing_file(tmp_path):
    x, _ = _corpus(14, n=200)
    _, ts = _stores(x)
    tm = TIndex(ts, PARAMS)
    assert tm.load(str(tmp_path)) == 0           # no file
    tm.dump(str(tmp_path))
    assert tm.load(str(tmp_path)) == 0           # an untrained dump
    assert convert.ivfflat_torch_to_arrays(tm) == {"trained": 0}
    js, _ = _stores(x)
    assert JIndex(js, PARAMS).load(str(tmp_path)) == 0


def test_compact_state_plain_form():
    """compact_state: the port's against the JAX package's."""
    codes, vids, docids, lens, *_ = _posting(15)
    js, ts = _states(codes, vids, docids, lens)
    jc, tc = jrt.compact_state(js), trt.compact_state(ts)
    np.testing.assert_array_equal(tc.lens.numpy(), np.asarray(jc.lens))
    for i, n in enumerate(np.asarray(jc.lens)):
        np.testing.assert_array_equal(tc.vids[i, :n].numpy(),
                                      np.asarray(jc.vids)[i, :n])
        np.testing.assert_array_equal(tc.codes[i, :n].numpy(),
                                      np.asarray(jc.codes)[i, :n])
        assert (tc.vids[i, n:] == -1).all()
