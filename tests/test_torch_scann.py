"""The port's ScaNN model (SCANN / VEARCH) and its anisotropic
quantization (gamma_tpu_torch/ops/avq.py) against the JAX package's.

On the same seeded numpy inputs: the loss, the assignment and the
closed-form update of one anisotropic Lloyd step (losses and centroids
to 1e-4 relative, assignments equal), train_avq from the same initial
codebooks (the two packages draw their k-means inits from different
generators, so both are handed one init; codebooks to 1e-3), encode_avq
under one codebook set (codes equal), and whole searches of one model
cross-loaded through the shared `.scann.npz` dump, dense and gather, in
both directions (the JAX side on its TPU code path with the kernels
interpreted; sorted distances to 1e-3).  Then the contract of
tests/test_scann.py on the port: the registry, parallel error below
plain PQ's, MIPS recall, dense mode and dump/load — and two trainings
from one seed giving the same bits without any index_add_."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.config import SearchParams as JSP
from gamma_tpu.index.scann import ScaNNIndex as JScaNN
from gamma_tpu.ops import avq as javq
from gamma_tpu.ops import pallas_gadc as jgadc
from gamma_tpu.ops import pq as jpq
from gamma_tpu.vector.raw_store import RawVectorStore as JStore
from gamma_tpu_torch.config import SearchParams
from gamma_tpu_torch.index import create_model
from gamma_tpu_torch.index.scann import ScaNNIndex
from gamma_tpu_torch.ops import avq, pq as pq_ops
from gamma_tpu_torch.vector.raw_store import RawVectorStore

from tests.conftest import make_blobs

D = 32


@pytest.fixture(scope="module")
def corpus():
    x = make_blobs(np.random.default_rng(31), 6000, D, n_clusters=32)
    # MIPS corpora are usually scale-varied; keep norms in [0.5, 1.5]
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x *= np.random.default_rng(5).uniform(0.5, 1.5, (x.shape[0], 1))
    return x.astype(np.float32)


@pytest.fixture
def jax_tpu_path(monkeypatch):
    """JAX search on its TPU branch, the grouped ADC kernel interpreted."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jgadc, "grouped_adc", functools.partial(
        jgadc.grouped_adc, interpret=True))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _sub_inputs(seed, n=2000, dsub=4, ksub=16):
    """One subspace's rows, directions and centroids."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dsub)).astype(np.float32)
    dirs = (x + 0.3 * rng.normal(size=(n, dsub))).astype(np.float32)
    xhat = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    cents = x[rng.choice(n, ksub, replace=False)]
    return x, xhat.astype(np.float32), cents


@pytest.mark.parametrize("t,d", [(0.2, 32), (0.2, 128), (0.5, 16),
                                 (0.0, 8), (1.5, 64)])
def test_eta_matches_jax(t, d):
    assert avq.eta_from_threshold(t, d) == javq.eta_from_threshold(t, d)


@pytest.mark.parametrize("seed", [0, 1])
def test_aniso_step_matches_jax(seed):
    x, xhat, cents = _sub_inputs(seed)
    eta = avq.eta_from_threshold(0.2, D)
    jc = np.asarray(javq._aniso_cost(jnp.asarray(x), jnp.asarray(xhat),
                                     jnp.asarray(cents), eta))
    tc = avq._aniso_cost(_t(x), _t(xhat), _t(cents), eta).numpy()
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-4)
    ja = np.asarray(javq._aniso_assign(jnp.asarray(x), jnp.asarray(xhat),
                                       jnp.asarray(cents), eta=eta))
    ta = avq._aniso_assign(_t(x), _t(xhat), _t(cents), eta=eta)
    np.testing.assert_array_equal(ta.numpy(), ja)
    jn, jk = javq._aniso_update(jnp.asarray(x), jnp.asarray(xhat),
                                jnp.asarray(ja), ksub=16, eta=eta)
    tn, tk = avq._aniso_update(_t(x), _t(xhat), ta, ksub=16, eta=eta)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-4,
                               atol=1e-5)


def _same_init(monkeypatch, x, M, nbits):
    """Both packages' train_avq start from one set of codebooks: plain PQ
    trained by the port, handed to both in place of their own init."""
    init = pq_ops.train_pq(_t(x), M, nbits=nbits, iters=6)
    cb = init.codebooks.numpy()
    monkeypatch.setattr(pq_ops, "train_pq", lambda *a, **k: init)
    monkeypatch.setattr(jpq, "train_pq", lambda *a, **k: jpq.PQCodebooks(
        jnp.asarray(cb), jnp.asarray((cb * cb).sum(-1))))


def test_train_and_encode_avq_match_jax(corpus, monkeypatch):
    x = corpus[:3000]
    rng = np.random.default_rng(8)
    dirs = (x + 0.2 * rng.normal(size=x.shape)).astype(np.float32)
    _same_init(monkeypatch, x, 8, 4)
    eta = avq.eta_from_threshold(0.2, D)
    tpq = avq.train_avq(_t(x), 8, dirs=_t(dirs), nbits=4, eta=eta, iters=4)
    jpq_ = javq.train_avq(jnp.asarray(x), 8, dirs=jnp.asarray(dirs),
                          nbits=4, eta=eta, iters=4)
    np.testing.assert_allclose(tpq.codebooks.numpy(),
                               np.asarray(jpq_.codebooks), rtol=1e-3,
                               atol=1e-4)
    # encode under ONE codebook set: the codes are equal
    tcodes = avq.encode_avq(tpq, _t(x), _t(dirs), M=8, eta=eta, chunk=1024)
    jcodes = javq.encode_avq(
        jpq.PQCodebooks(jnp.asarray(tpq.codebooks.numpy()),
                        jnp.asarray(tpq.cb_norms.numpy())),
        jnp.asarray(x), jnp.asarray(dirs), M=8, eta=eta, chunk=1024)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))


def test_train_avq_twice_same_bits_without_index_add(corpus, monkeypatch):
    """Two trainings from one seed give the same bits, and none calls
    index_add_ (whose atomics add in a changing order on the card)."""
    def refuse(*a, **k):
        raise AssertionError("index_add_ called in AVQ training")

    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    x = _t(corpus[:2000])
    a = avq.train_avq(x, 8, nbits=4, iters=3, seed=3)
    b = avq.train_avq(x, 8, nbits=4, iters=3, seed=3)
    assert torch.equal(a.codebooks, b.codebooks)
    store = RawVectorStore("v", D, device="cpu")
    store.add(corpus[:3000])
    store.flush_device()
    models = []
    for _ in range(2):
        m = ScaNNIndex(store, {"ncentroids": 16, "nsubvector": 8,
                               "nbits_per_idx": 4})
        m.train(corpus[:3000])
        ids = np.arange(3000)
        m.add(corpus[:3000], ids, ids)
        models.append(m)
    assert torch.equal(models[0].pq.codebooks, models[1].pq.codebooks)
    assert torch.equal(models[0].centroids, models[1].centroids)
    assert torch.equal(models[0].state.codes, models[1].state.codes)


def test_registry_names():
    store = RawVectorStore("v", 16, device="cpu")
    for name in ("SCANN", "VEARCH"):
        m = create_model(name, store, {"ncentroids": 8})
        assert isinstance(m, ScaNNIndex)
        assert m.p.metric_type.name == "INNER_PRODUCT"
        assert m.eta > 0.0 and m.sq_payload == "pq"
    # eta grows with dimension (Guo et al. eta(T) = (d-1)T^2/(1-T^2))
    assert (avq.eta_from_threshold(0.2, 128)
            > avq.eta_from_threshold(0.2, 16))


def test_avq_parallel_error_reduced(corpus):
    """The anisotropic codebooks trade orthogonal error for parallel
    error: the mean squared PARALLEL residual drops below plain PQ's."""
    x = _t(corpus[:3000])
    plain = pq_ops.train_pq(x, 8, nbits=4, iters=10)
    aniso = avq.train_avq(x, 8, nbits=4, iters=10)

    def par_err(pq):
        rec = pq_ops.decode_pq(pq, pq_ops.encode_pq(pq, x))[:, :D]
        r = (x - rec).numpy()
        xh = x.numpy() / np.linalg.norm(x.numpy(), axis=1, keepdims=True)
        return float(np.mean(np.sum(r * xh, axis=1) ** 2))

    assert par_err(aniso) < par_err(plain)


def _model(corpus, params, store=None):
    store = store or RawVectorStore("v", D, device="cpu")
    if store.n == 0:
        store.add(corpus)
        store.flush_device()
    m = ScaNNIndex(store, params)
    m.train(corpus)
    ids = np.arange(corpus.shape[0], dtype=np.int64)
    m.add(corpus, ids, ids)
    return m


def _search(m, q, sp, k=10):
    d, docs, _ = m.search(_t(q), torch.zeros(m.store.device.shape[0]),
                          SearchParams.from_dict(sp), k)
    return d.numpy(), docs.numpy()


def test_mips_recall(corpus):
    idx = _model(corpus, {"ncentroids": 64, "nsubvector": 8, "nprobe": 16})
    rng = np.random.default_rng(3)
    queries = corpus[rng.choice(6000, 32, replace=False)]
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    gt = np.argsort(-(queries @ corpus.T), axis=1)[:, :10]
    _, docs = _search(idx, queries, {"scan_mode": "gather", "nprobe": 16,
                                     "recall_num": 100, "has_rank": True})
    recall = np.mean([len(set(docs[i]) & set(gt[i])) / 10
                      for i in range(32)])
    assert recall >= 0.85, recall
    # rank 1 is the true MIPS argmax (not necessarily the query's own
    # doc: larger-norm docs in the same direction rightly win)
    gt1 = int(np.argmax(corpus @ corpus[5]))
    _, d5 = _search(idx, corpus[5:6], {"scan_mode": "gather", "nprobe": 64,
                                       "recall_num": 200, "has_rank": True},
                    5)
    assert gt1 in d5[0].tolist()


def test_dense_mode_and_dump_load(corpus, tmp_path):
    params = {"ncentroids": 64, "nsubvector": 8, "nprobe": 64}
    idx = _model(corpus, params)
    assert idx.scan_mode(SearchParams()) == "dense"
    spd = {"scan_mode": "dense", "recall_num": 100}
    before = _search(idx, corpus[:8], spd)
    idx.dump(str(tmp_path))
    idx2 = ScaNNIndex(idx.store, params)
    assert idx2.load(str(tmp_path)) == idx.indexed_count
    after = _search(idx2, corpus[:8], spd)
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_array_equal(after[0], before[0])


def test_opq_is_the_init_rotation_alone(corpus):
    """With has_opq the model keeps the OPQ init rotation and refines
    nothing, as the JAX package's ScaNN does, so the IVFPQ model's OPQ
    deviation (ROADMAP.md C3: codebooks refit under the whole rotation)
    does not enter: the rotation equals the JAX package's PCA basis up
    to the sign of each column."""
    x = corpus[:3000]
    m = ScaNNIndex(RawVectorStore("v", D, device="cpu"),
                   {"ncentroids": 16, "nsubvector": 8, "has_opq": True})
    m.train(x)
    jm = JScaNN(JStore("v", D), {"ncentroids": 16, "nsubvector": 8,
                                 "has_opq": True})
    jrot = np.asarray(jm._train_opq_init(jnp.asarray(x)))
    rot = m.opq_rot.numpy()
    np.testing.assert_allclose(np.abs((rot * jrot).sum(0)), 1.0, atol=1e-3)


def _agree(a, b, rtol=1e-3):
    (da, ia), (db, ib) = a, b
    np.testing.assert_allclose(np.sort(db, 1), np.sort(da, 1), rtol=rtol,
                               atol=1e-3)
    overlap = np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(ia, ib)])
    assert overlap >= 0.95, overlap


@pytest.mark.parametrize("mode", ["dense", "gather"])
def test_scann_dump_cross_loads_both_ways(corpus, tmp_path, jax_tpu_path,
                                          mode):
    """A JAX ScaNN model's `.scann.npz` loads into the port and the two
    answer alike (IP; gather runs B3's inner-product form with the
    exact rerank); the port's dump loads back into the JAX package."""
    x = corpus[:4000]
    params = {"ncentroids": 32, "nsubvector": 8, "nprobe": 16}
    js = JStore("v", D)
    js.add(x)
    js.flush_device()
    jm = JScaNN(js, params)
    jm.train(x)
    ids = np.arange(x.shape[0])
    jm.add(x, ids, ids)
    jm.dump(str(tmp_path / "j"))
    ts = RawVectorStore("v", D, device="cpu")
    ts.add(x)
    ts.flush_device()
    tm = ScaNNIndex(ts, params)
    assert tm.load(str(tmp_path / "j")) == x.shape[0]
    q = corpus[4000:4024]
    sp = {"scan_mode": mode, "recall_num": 64, "has_rank": True}

    def jsearch(m):
        d, doc, _ = m.search(jnp.asarray(q), jnp.zeros(js.device.shape[0]),
                             JSP.from_dict(sp), 10)
        return np.asarray(d), np.asarray(doc)

    t = _search(tm, q, sp)
    _agree(jsearch(jm), t)
    # the port's dump → the JAX package
    tm.dump(str(tmp_path / "t"))
    jm2 = JScaNN(js, params)
    assert jm2.load(str(tmp_path / "t")) == x.shape[0]
    _agree(jsearch(jm2), t)
    # the rerank scores the exact inner product with the stored (bf16
    # mirror) rows
    xs = _t(x).bfloat16().float().numpy()
    np.testing.assert_allclose(-t[0], np.einsum("qd,qkd->qk", q, xs[t[1]]),
                               rtol=1e-4, atol=1e-4)
