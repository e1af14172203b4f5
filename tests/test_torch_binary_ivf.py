"""The port's BINARYIVF model and its Hamming scan
(ops/ivf_scan.binary_ivf_search) against the JAX package's.

On the same seeded numpy inputs: the sign-bit packing (bytes equal,
also on the device path `pack_bits`), the population count (against
np.unpackbits, for row widths that take the int32-word path and for
those that take the byte table), binary_ivf_search over one posting
state (Hamming distances are exact integers, so the sorted distances
must be EQUAL; ids are compared by their distances, since ties are the
rule), and the model's cycle: train, add, search, delete, dump and load,
with the `.bivf.npz` dump loading across both packages in both
directions with equal distances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamma_tpu.config import SearchParams as JSP
from gamma_tpu.index import binary_ivf as jbivf
from gamma_tpu.ops import ivf_scan as jscan
from gamma_tpu.vector.raw_store import RawVectorStore as JStore
from gamma_tpu_torch.config import SearchParams
from gamma_tpu_torch.index import binary_ivf as tbivf
from gamma_tpu_torch.index import create_model
from gamma_tpu_torch.ops import ivf_scan
from gamma_tpu_torch.realtime.invert_index import IVFState
from gamma_tpu_torch.vector.raw_store import RawVectorStore

D = 64


def _corpus(seed, n=4000, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(24, d)).astype(np.float32)
    x = (centers[rng.integers(0, 24, n)]
         + 0.6 * rng.normal(size=(n, d))).astype(np.float32)
    q = (x[rng.choice(n, 24, replace=False)]
         + 0.3 * rng.normal(size=(24, d))).astype(np.float32)
    return x, q


_POP = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                     axis=1).sum(1)


def _hamming_np(a_bits, b_bits):
    """Hamming distances of packed rows a [n, W] to b [m, W] → [n, m]."""
    return _POP[a_bits[:, None, :] ^ b_bits[None, :, :]].sum(-1)


@pytest.mark.parametrize("d", [7, 16, 20, 64, 128])
def test_pack_bits_matches_jax(d):
    x = np.random.default_rng(d).normal(size=(50, d)).astype(np.float32)
    x[0] = 0.0                                   # zero packs as bit 0
    ref = jbivf.pack_bits_np(x)
    np.testing.assert_array_equal(tbivf.pack_bits_np(x), ref)
    np.testing.assert_array_equal(
        tbivf.pack_bits(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("w", [1, 3, 4, 5, 8, 16, 20])
def test_popcount_matches_unpackbits(w):
    rng = np.random.default_rng(w)
    x = rng.integers(0, 256, (7, 30, w), dtype=np.uint8)
    x[0, 0] = 255                                # every bit, sign included
    x[0, 1] = 128
    x[0, 2] = 0
    got = ivf_scan.popcount_bytes(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.unpackbits(x, axis=-1).sum(-1))


def _state_from(jm):
    st = jm.state
    return IVFState(*(torch.from_numpy(np.array(a)) for a in
                      (st.codes, st.vids, st.docids, st.lens)))


@pytest.mark.parametrize("d,nprobe,k", [(64, 6, 10), (40, 4, 7),
                                        (64, 32, 20)])
def test_binary_ivf_search_matches_jax(d, nprobe, k):
    """One posting state (the JAX model's) and the same query bits and
    penalty through both scans: equal Hamming distances, and each id's
    distance is its recomputed Hamming distance.  d 40 packs 5-byte rows
    (the byte-table count), 64 8-byte rows (the word count)."""
    x, q = _corpus(d, d=d)
    jm = jbivf.BinaryIVFIndex(JStore("v", d), {"ncentroids": 32})
    jm.train(x)
    ids = np.arange(x.shape[0])
    jm.add(x, ids, ids)
    pen = np.zeros(x.shape[0] + 64, np.float32)
    pen[::5] = 3.0e38                            # a filter masks 1 in 5
    qb = jbivf.pack_bits_np(q)
    cb = np.array(jm.centroid_bits)
    jd, jdoc, _ = jscan.binary_ivf_search(
        jm.state, jnp.asarray(cb), jnp.asarray(qb), jnp.asarray(pen),
        nprobe=nprobe, k=k)
    td, tdoc, tvid = ivf_scan.binary_ivf_search(
        _state_from(jm), torch.from_numpy(cb), torch.from_numpy(qb),
        torch.from_numpy(pen), nprobe=nprobe, k=k)
    td, tdoc = td.numpy(), tdoc.numpy()
    np.testing.assert_array_equal(np.sort(td, 1), np.sort(np.asarray(jd), 1))
    live = td < 1e37
    assert live.all()
    xb = jbivf.pack_bits_np(x)
    for i in range(q.shape[0]):
        np.testing.assert_array_equal(
            td[i], _hamming_np(qb[i:i + 1], xb[tdoc[i]])[0])
    assert (tdoc % 5 != 0).all() and (tvid.numpy() == tdoc).all()


def test_binary_ivf_search_in_query_chunks(monkeypatch):
    """Queries split into gather-budget chunks answer as one batch."""
    x, q = _corpus(3)
    m = tbivf.BinaryIVFIndex(RawVectorStore("v", D, device="cpu"),
                             {"ncentroids": 16})
    m.train(x)
    ids = np.arange(x.shape[0])
    m.add(x, ids, ids)
    sp = SearchParams.from_dict({"nprobe": 8})
    pen = torch.zeros(x.shape[0])
    whole = m.search(torch.from_numpy(q), pen, sp, 10)
    monkeypatch.setattr(ivf_scan, "FLAT_GATHER_BYTES", 1 << 16)
    parts = m.search(torch.from_numpy(q), pen, sp, 10)
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _search(m, q, nprobe=8, k=10):
    pen = torch.zeros(8192)
    d, doc, _ = m.search(torch.from_numpy(q), pen,
                         SearchParams.from_dict({"nprobe": nprobe}), k)
    return d.numpy(), doc.numpy()


def _jsearch(m, q, nprobe=8, k=10):
    d, doc, _ = m.search(jnp.asarray(q), jnp.zeros(8192),
                         JSP.from_dict({"nprobe": nprobe}), k)
    return np.asarray(d), np.asarray(doc)


def test_model_cycle_and_dump_both_ways(tmp_path):
    x, q = _corpus(5)
    m = create_model("BINARYIVF", RawVectorStore("v", D, device="cpu"),
                     {"ncentroids": 32})
    assert isinstance(m, tbivf.BinaryIVFIndex)
    m.train(x)
    ids = np.arange(x.shape[0])
    m.add(x[:3000], ids[:3000], ids[:3000])
    m.add(x[3000:], ids[3000:], ids[3000:])
    assert m.indexed_count == x.shape[0]
    # a stored row finds itself at distance 0
    d, doc = _search(m, x[:16], nprobe=32)
    assert (d[:, 0] == 0).all()
    assert all(i in doc[i] for i in range(16))
    m.delete(np.arange(16))
    d, doc = _search(m, x[:16], nprobe=32)
    assert not np.isin(doc, np.arange(16)).any()
    before = _search(m, q)
    m.dump(str(tmp_path / "t"))
    # the port's dump → a fresh port model and the JAX package
    m2 = tbivf.BinaryIVFIndex(RawVectorStore("v", D, device="cpu"),
                              {"ncentroids": 32})
    assert m2.load(str(tmp_path / "t")) == x.shape[0]
    after = _search(m2, q)
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])
    js = JStore("v", D)
    js.add(x)
    jm = jbivf.BinaryIVFIndex(js, {"ncentroids": 32})
    assert jm.load(str(tmp_path / "t")) == x.shape[0]
    np.testing.assert_array_equal(np.sort(_jsearch(jm, q)[0], 1),
                                  np.sort(before[0], 1))
    # the JAX package's dump → the port
    jm.add(x[:16], ids[:16], ids[:16])           # the deleted rows again
    jm.dump(str(tmp_path / "j"))
    m3 = tbivf.BinaryIVFIndex(RawVectorStore("v", D, device="cpu"),
                              {"ncentroids": 32})
    assert m3.load(str(tmp_path / "j")) == x.shape[0]
    np.testing.assert_array_equal(np.sort(_search(m3, x[:16], 32)[0], 1),
                                  np.sort(_jsearch(jm, x[:16], 32)[0], 1))
    assert (_search(m3, x[:16], 32)[0][:, 0] == 0).all()
