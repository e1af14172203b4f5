"""The in-memory compression tiers of the store mirror (tests/test_compress.py
on the port): `VectorInfo(store_param={"device_dtype": ...})` with the
fp8 (e4m3) mirror and the bf16 default, through every retrieval model
and both gather payloads of IVFPQ, on the JAX test's size (32-d blobs,
3,000 docs).

A JAX engine ingests the docs and writes a legacy dump; the port's
engine loads it, so both search one trained index over mirrors that
hold the same rounded rows.  Per case:

  * each store mirror's element size: 1 byte for fp8, 2 for bf16;
  * the mirrors hold the same rounded rows, bit for bit;
  * the port's recall@10 against exact f64 neighbours of the f32 docs
    is at least the JAX test's floor for the tier (0.80 for fp8, 0.95
    for bf16; BINARYIVF against exact Hamming neighbours, tie-aware;
    SCANN against inner-product neighbours, see FLOOR) and at least the
    JAX engine's own recall less 0.01 (BINARYIVF: see below);
  * the distances of each side's chosen ids agree: per query the sorted
    reported distances to 1e-3 relative and 2e-3 absolute (near-ties may
    swap ids, not distances; both sides score the same rounded values
    in f32, in other summation orders); where a model reranks over the
    mirror, the port's reported distance of every id it returns equals
    its distance recomputed in f64 from the mirror's rounded rows to the
    same tolerance; BINARYIVF's Hamming distances exactly, over the sign
    bits of the rounded rows, and equal to JAX's on every query whose
    probed lists admit no tie;
  * IVFPQ's cases also run the sharded search on both sides: the port
    on two CPU shards (`devices=[cpu] * 2`), JAX on two of the
    conftest's virtual devices, held to the same tolerance against each
    other and against the port's single search.

The JAX side runs its TPU code path with the Pallas kernels interpreted
(as tests/test_torch_ivfpq.py does, and the sharded SQ8 body on its
"pallas" scan as tests/test_torch_sharded.py does), so the SQ8 gather
rounds the scan's query operand to bf16 on both sides."""

import functools

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import gamma_tpu
import gamma_tpu.parallel as jpar
import gamma_tpu_torch
from gamma_tpu.ops import pallas_gadc as jgadc
from gamma_tpu.ops import pallas_gsq as jgsq

from tests.conftest import make_blobs

D, N, NQ = 32, 3000, 32
IVF = {"ncentroids": 32, "nsubvector": 8, "nprobe": 16}
# case → (retrieval type, model params, request retrieval params, what
# its reported distances are computed over: the store mirror's rows, the
# model's own payload (IVFFLAT's bf16 rows, the SQ8 sidecar's codes) or
# the sign bits (Hamming))
MODELS = {
    "ivfpq_dense": ("IVFPQ", IVF, {}, "mirror"),
    "ivfpq_sq8": ("IVFPQ", IVF, {"scan_mode": "gather"}, "payload"),
    "ivfpq_pq": ("IVFPQ", dict(IVF, gather_payload="pq"),
                 {"scan_mode": "gather"}, "mirror"),
    "fastscan": ("IVFPQ_FASTSCAN", dict(IVF, nsubvector=16), {}, "mirror"),
    "ivfflat": ("IVFFLAT", {"ncentroids": 32}, {"nprobe": 16}, "payload"),
    "flat": ("FLAT", {}, {}, "mirror"),
    "hnsw": ("HNSW", {"nlinks": 16, "efSearch": 64}, {}, "mirror"),
    "scann": ("SCANN", IVF, {"recall_num": 128}, "mirror"),
    "binaryivf": ("BINARYIVF", {"ncentroids": 16}, {"nprobe": 8},
                  "hamming"),
}
# recall@10 floors: the JAX test's (tests/test_compress.py) for each tier;
# SCANN's inner product over fp8 rows reaches 0.79 on these blobs in
# both packages alike (the JAX package sets no floor for it), so it is
# held at 0.75 there and to the JAX engine's own recall besides
FLOOR = {"float8": 0.80, "bfloat16": 0.95}
SCANN_FP8_FLOOR = 0.75
ROUND = {"float8": ml_dtypes.float8_e4m3fn, "bfloat16": ml_dtypes.bfloat16}


@pytest.fixture
def jax_tpu_path(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jgsq, "grouped_sq_scan", functools.partial(
        jgsq.grouped_sq_scan, interpret=True))
    monkeypatch.setattr(jgadc, "grouped_adc", functools.partial(
        jgadc.grouped_adc, interpret=True))
    # the sharded SQ8 body picks its scan by the mesh's platform
    monkeypatch.setattr(jpar, "sharded_ivfsq_search_fn", functools.partial(
        jpar.sharded_ivfsq_search_fn, scan_impl="pallas"))


def _engine(pkg, path, model, params, dd, **cfg):
    kw = {"device": "cpu"} if pkg is gamma_tpu_torch else {}
    eng = pkg.GammaEngine(pkg.EngineConfig(path=str(path), **cfg), **kw)
    eng.create_table(pkg.TableInfo(
        name="t",
        fields=[pkg.FieldInfo("price", pkg.config.DataType.FLOAT, True)],
        vectors=[pkg.VectorInfo("emb", D, store_param={"device_dtype": dd})],
        indexing_size=1500, retrieval_types=[model],
        retrieval_params=[params]))
    return eng


def _top(pkg, eng, q, rp):
    res = eng.search(pkg.Request(topn=10, vec_fields=[
        pkg.VectorQuery("emb", q)], retrieval_params=dict(rp))).results
    ids = np.full((len(res), 10), -1)
    dist = np.full((len(res), 10), np.inf)
    for i, sr in enumerate(res):
        for j, it in enumerate(sr.result_items[:10]):
            ids[i, j], dist[i, j] = it.docid, it.score
    return ids, dist


def _truth(model, x, q):
    """The exact top-10 of each query and the distance function of the
    model's metric, in f64: squared L2, negated inner product (SCANN),
    or Hamming over sign bits (BINARYIVF)."""
    x, q = x.astype(np.float64), q.astype(np.float64)
    if model == "BINARYIVF":
        def dist(a, b):
            return ((a[:, None, :] > 0) != (b > 0)).sum(-1).astype(float)
    elif model == "SCANN":
        def dist(a, b):
            return -np.einsum("qd,qkd->qk", a, b) if b.ndim == 3 \
                else -a @ b.T
    else:
        def dist(a, b):
            if b.ndim == 3:
                return ((a[:, None, :] - b) ** 2).sum(-1)
            return ((a ** 2).sum(1)[:, None] - 2 * a @ b.T
                    + (b ** 2).sum(1)[None, :])
    full = dist(q, x) if model != "BINARYIVF" else np.stack(
        [dist(q[i:i + 1], x)[0] for i in range(q.shape[0])])
    return np.argsort(full, 1, kind="stable")[:, :10], full, dist


def _recall(ids, gt, full):
    """recall@10 with ties at the 10th distance counted as hits."""
    hits = 0
    for i in range(ids.shape[0]):
        kth = full[i, gt[i, -1]]
        got = ids[i][ids[i] >= 0]
        hits += min(10, int((full[i, got] <= kth).sum()))
    return hits / ids.size


def _agree(jd, td):
    live = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), live)
    np.testing.assert_allclose(np.sort(td, 1)[live], np.sort(jd, 1)[live],
                               rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("dd", ["float8", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MODELS))
def test_compressed_mirror_matches_jax(tmp_path, jax_tpu_path, case, dd):
    model, params, rp, scored = MODELS[case]
    rng = np.random.default_rng(13)
    x = make_blobs(rng, N, D, n_clusters=32)
    q = x[rng.choice(N, NQ, replace=False)]
    jeng = _engine(gamma_tpu, tmp_path, model, params, dd,
                   native_persistence=False)
    docs = [gamma_tpu.Doc(key=f"k{i}", fields={"price": float(i)},
                          vectors={"emb": x[i]}) for i in range(N)]
    for s in range(0, N, 1000):
        assert all(c == 0 for c in jeng.add_or_update_docs(docs[s:s + 1000]))
    jeng.flush()
    assert jeng.dump() == 0
    teng = gamma_tpu_torch.GammaEngine(gamma_tpu_torch.EngineConfig(
        path=str(tmp_path), native_persistence=False), device="cpu")
    assert teng.load() == 0
    tstore = teng.vm.stores["emb"]
    jstore = jeng.vm.stores["emb"]
    size = 1 if dd == "float8" else 2
    assert tstore.device.element_size() == size
    assert jstore.device.dtype.itemsize == size
    if dd == "float8":
        assert tstore.device.dtype == torch.float8_e4m3fn
    # the port's mirror holds the JAX mirror's rounded rows, bit for bit
    rows = tstore.device[:N].view(torch.uint8 if size == 1 else torch.int16)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jstore.device[:N]).view(rows.numpy().dtype))

    gt, full, dist = _truth(model, x, q)
    jids, jd = _top(gamma_tpu, jeng, q, rp)
    tids, td = _top(gamma_tpu_torch, teng, q, rp)
    recall = _recall(tids, gt, full)
    floor = (SCANN_FP8_FLOOR if (model, dd) == ("SCANN", "float8")
             else FLOOR[dd])
    assert recall >= floor, (case, dd, recall)
    if scored != "hamming":     # BINARYIVF's probe ties: below
        assert recall >= _recall(jids, gt, full) - 0.01, (case, dd, recall)
    # every returned id's distance, recomputed over the rounded rows
    rounded = x.astype(ROUND[dd]).astype(np.float64)
    live = tids >= 0
    want = dist(q.astype(np.float64), rounded[np.maximum(tids, 0)])
    if scored == "hamming":
        np.testing.assert_array_equal(td[live], want[live])
        # the lists probed are the nprobe nearest centroids in Hamming
        # distance, integers: where the nprobe-th and the next tie, the
        # two packages' top-k break the tie alike or not.  Elsewhere
        # they probe the same lists and find the same distances
        m = teng.vm.index_for("emb")
        cb = np.unpackbits(m.centroid_bits.numpy(), axis=1,
                           bitorder="little")[:, :D]
        coarse = np.sort(((q[:, None, :] > 0) != cb).sum(-1), 1)
        clear = coarse[:, rp["nprobe"] - 1] < coarse[:, rp["nprobe"]]
        assert clear.mean() >= 0.5
        np.testing.assert_array_equal(np.sort(td, 1)[clear],
                                      np.sort(jd, 1)[clear])
    else:
        _agree(jd, td)
        if scored == "mirror":
            np.testing.assert_allclose(td[live], want[live], rtol=1e-3,
                                       atol=2e-3)

    if model == "IVFPQ":
        teng.enable_sharded_search(n_list_shards=2, n_query_shards=1,
                                   devices=[torch.device("cpu")] * 2)
        jeng.enable_sharded_search(n_list_shards=2, n_query_shards=1)
        sj_ids, sjd = _top(gamma_tpu, jeng, q, rp)
        st_ids, std = _top(gamma_tpu_torch, teng, q, rp)
        assert _recall(st_ids, gt, full) >= FLOOR[dd]
        _agree(sjd, std)
        _agree(td, std)
    jeng.close()
    teng.close()
