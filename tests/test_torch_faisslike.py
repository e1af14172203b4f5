"""The port's faiss-like facade (gamma_tpu_torch.faisslike) against the
JAX package's: the twins of tests/test_faisslike.py (without HNSW, whose
model the port does not hold yet), and IndexScaNN / IndexBinaryIVF, with
D and I of both facades side by side.  FLAT and IVFFLAT train nothing or only centroids, which are
carried across, so their D agree to 1e-3 and their I away from ties;
the IVFPQ family trains codebooks with each framework's own random
numbers, so there the twins are held to the reference tests' own bars
and to each other through a dump."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu import faisslike as jf
from gamma_tpu_torch import faisslike as tf

from conftest import make_blobs


@pytest.fixture(scope="module")
def small():
    return make_blobs(np.random.default_rng(21), 2000, 32)


@pytest.fixture(scope="module")
def medium():
    return make_blobs(np.random.default_rng(22), 6000, 32, n_clusters=48)


def _agree(a, b, min_overlap=0.95):
    (da, ia), (db, ib) = a, b
    assert da.dtype == db.dtype == np.float32
    assert ia.dtype == ib.dtype == np.int64 and ia.shape == ib.shape
    np.testing.assert_array_equal(ib < 0, ia < 0)
    live = ia >= 0
    np.testing.assert_allclose(np.sort(db, 1)[live], np.sort(da, 1)[live],
                               rtol=1e-3, atol=1e-3)
    overlap = np.mean([len(set(x) & set(y)) / len(set(x))
                       for x, y in zip(ia, ib)])
    assert overlap >= min_overlap, overlap


def test_exports_and_device_default():
    assert {"Index", "IndexFlat", "IndexIVFPQ", "IndexIVFPQFastScan",
            "IndexIVFFlat", "IndexScaNN", "IndexBinaryIVF"} <= set(dir(tf))
    assert not hasattr(tf, "IndexHNSW")    # arrives with its model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            tf.IndexFlat(8)
    idx = tf.IndexIVFFlat(8, nlist=4, device="cpu")
    assert idx.store.dev.type == "cpu" and idx.model.device.type == "cpu"
    assert idx.model.p.ncentroids == 4


def test_flat_exact(small):
    ji, ti = jf.IndexFlat(32), tf.IndexFlat(32, device="cpu")
    ji.add(small)
    ti.add(small)
    assert ti.ntotal == ji.ntotal == 2000 and ti.is_trained
    a, b = ji.search(small[:8], k=3), ti.search(small[:8], k=3)
    _agree(a, b)
    D, I = b
    assert (I[:, 0] == np.arange(8)).all()
    assert np.all(D[:, 0] < 0.5)   # self-distance, bf16 mirror


def test_flat_batch_size_does_not_matter(small):
    """The JAX facade pads a batch to a power of two; the port does not.
    Results per query are the same whatever the batch."""
    ti = tf.IndexFlat(32, device="cpu")
    ti.add(small)
    D5, I5 = ti.search(small[:5], k=4)
    D8, I8 = ti.search(small[:8], k=4)
    np.testing.assert_array_equal(I5, I8[:5])
    np.testing.assert_allclose(D5, D8[:5], rtol=1e-6)
    D1, I1 = ti.search(small[3], k=4)          # a single vector
    np.testing.assert_array_equal(I1[0], I8[3])


def test_ip_metric(small):
    ji, ti = jf.IndexFlat(32, metric="ip"), tf.IndexFlat(32, metric="ip",
                                                         device="cpu")
    ji.add(small)
    ti.add(small)
    a, b = ji.search(small[:4], k=1), ti.search(small[:4], k=1)
    _agree(a, b)
    D, I = b
    expect = np.einsum("nd,nd->n", small[:4], small[:4])
    got = np.einsum("nd,nd->n", small[:4], small[I[:, 0]])
    assert np.all(got >= expect - 1e-2)
    assert np.all(D > 0)             # the (positive) inner product


def test_flat_remove_dump_load(tmp_path, small):
    ji, ti = jf.IndexFlat(32), tf.IndexFlat(32, device="cpu")
    for idx in (ji, ti):
        idx.add(small[:1000])
        idx.add(small[1000:])        # a second batch grows the penalty
        idx.remove_ids(np.array([0, 1, 5000, -3]))   # out of range: ignored
    a, b = ji.search(small[:4], k=3), ti.search(small[:4], k=3)
    _agree(a, b)
    assert 0 not in b[1][0] and 1 not in b[1][1]
    ti.dump(str(tmp_path))
    t2 = tf.IndexFlat(32, device="cpu")
    assert t2.load(str(tmp_path)) == 2000 and t2.ntotal == 2000
    c = t2.search(small[:4], k=3)
    np.testing.assert_array_equal(c[1], b[1])
    np.testing.assert_allclose(c[0], b[0], rtol=1e-6)
    np.testing.assert_allclose(t2.reconstruct(7), small[7])
    # the port's dump (store rows + removed ids) loads in the JAX facade
    j2 = jf.IndexFlat(32)
    j2.load(str(tmp_path))
    _agree(j2.search(small[:4], k=3), c)


def test_ivfflat_matches_jax(tmp_path, small):
    """IndexIVFFlat with the JAX facade's centroids carried across:
    D, I side by side, deletes, and the dump both ways."""
    ji = jf.IndexIVFFlat(32, nlist=16)
    ti = tf.IndexIVFFlat(32, nlist=16, device="cpu", scan_impl="gather")
    assert not ti.is_trained
    ji.train(small)
    ti.model.centroids = torch.from_numpy(np.array(ji.model.centroids))
    ti.model.cent_norms = (ti.model.centroids ** 2).sum(-1)
    ti.model._trained = True
    ji.add(small)
    ti.add(small)
    a = ji.search(small[:8], k=3, nprobe=8)
    b = ti.search(small[:8], k=3, nprobe=8)
    _agree(a, b)
    assert np.mean([i in b[1][i].tolist() for i in range(8)]) >= 0.9
    for idx in (ji, ti):
        idx.remove_ids(np.array([0, 1]))
    a = ji.search(small[:8], k=3, nprobe=8)
    b = ti.search(small[:8], k=3, nprobe=8)
    _agree(a, b)
    assert 0 not in b[1][0] and 1 not in b[1][1]
    ji.dump(str(tmp_path / "j"))
    t2 = tf.IndexIVFFlat(32, nlist=16, device="cpu", scan_impl="gather")
    assert t2.load(str(tmp_path / "j")) == 2000
    _agree(a, t2.search(small[:8], k=3, nprobe=8))
    ti.dump(str(tmp_path / "t"))
    j2 = jf.IndexIVFFlat(32, nlist=16)
    assert j2.load(str(tmp_path / "t")) == 2000
    _agree(j2.search(small[:8], k=3, nprobe=8), b)


def test_ivfflat_trains_itself(small):
    """The twin of test_ivfflat_and_hnsw's IVFFLAT half: the port's own
    training, on the grouped scan (the default)."""
    idx = tf.IndexIVFFlat(32, nlist=16, device="cpu")
    idx.train(small)
    idx.add(small)
    _, I = idx.search(small[:8], k=3)
    assert np.mean([i in I[i].tolist() for i in range(8)]) >= 0.9


@pytest.mark.parametrize("cls,kw", [("IndexIVFPQ", dict(nlist=32, m=8)),
                                    ("IndexIVFPQFastScan",
                                     dict(nlist=32, m=16))])
def test_ivfpq_lifecycle(tmp_path, medium, cls, kw):
    """The twin of test_ivfpq_lifecycle, for both IVFPQ facades, and the
    port's dump loaded by the JAX facade: both then return the same
    neighbours (dense scan over the same codes, exact rerank)."""
    idx = getattr(tf, cls)(32, device="cpu", **kw)
    assert not idx.is_trained
    idx.train(medium[:4000])
    assert idx.is_trained
    idx.add(medium)
    assert idx.ntotal == medium.shape[0]
    D, I = idx.search(medium[:16], k=5, recall_num=512)
    assert (I[:, 0] == np.arange(16)).mean() >= 0.9
    idx.remove_ids(np.array([0, 1]))
    _, I2 = idx.search(medium[:2], k=3, recall_num=512)
    assert 0 not in I2[0] and 1 not in I2[1]
    idx.dump(str(tmp_path))
    idx2 = getattr(tf, cls)(32, device="cpu", **kw)
    idx2.load(str(tmp_path))
    D3, I3 = idx2.search(medium[4:8], k=3, recall_num=512)
    assert all(4 + i in I3[i].tolist() for i in range(4))
    jdx = getattr(jf, cls)(32, **kw)
    jdx.load(str(tmp_path))
    _agree(jdx.search(medium[4:8], k=3, recall_num=512), (D3, I3))


def test_scann_facade_and_jax_load(tmp_path, medium):
    """IndexScaNN: inner product by default (D holds the scores, largest
    first), the true MIPS argmax found, removal, and the port's dump
    loaded by the JAX facade: both answer alike (dense over the same
    codes, exact rerank)."""
    idx = tf.IndexScaNN(32, nlist=32, m=8, device="cpu")
    assert idx.metric == "ip"
    idx.train(medium[:4000])
    idx.add(medium)
    q = medium[:16]
    D, I = idx.search(q, k=5, recall_num=256)
    assert (np.diff(D, axis=1) <= 0).all()
    gt1 = np.argmax(q @ medium.T, axis=1)
    assert np.mean([g in row for g, row in zip(gt1, I)]) >= 0.9
    idx.remove_ids(gt1[:2])
    _, I2 = idx.search(q[:2], k=5, recall_num=256)
    assert gt1[0] not in I2[0] and gt1[1] not in I2[1]
    idx.dump(str(tmp_path))
    jdx = jf.IndexScaNN(32, nlist=32, m=8)
    jdx.load(str(tmp_path))
    _agree(jdx.search(q[4:12], k=5, recall_num=256),
           idx.search(q[4:12], k=5, recall_num=256))


def test_binary_ivf_facade_and_jax_load(tmp_path, medium):
    """IndexBinaryIVF: D holds Hamming distances of the sign bits, a
    stored row finds itself at 0, and the JAX facade loads the port's
    dump and returns the same distances."""
    idx = tf.IndexBinaryIVF(32, ncentroids=16, device="cpu")
    idx.train(medium)
    idx.add(medium)
    D, I = idx.search(medium[:16], k=5, nprobe=16)
    assert (D[:, 0] == 0).all()
    bits = (medium > 0)
    for i in range(16):
        np.testing.assert_array_equal(
            D[i], (bits[I[i]] != bits[i]).sum(1).astype(np.float32))
    idx.dump(str(tmp_path))
    jdx = jf.IndexBinaryIVF(32, ncentroids=16)
    jdx.load(str(tmp_path))
    jD, _ = jdx.search(medium[:16], k=5, nprobe=16)
    np.testing.assert_array_equal(np.sort(jD, 1), np.sort(D, 1))
