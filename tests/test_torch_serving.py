"""The port's serving surface: gamma_tpu_torch.c_api, .idl.wire, .server
and .cluster, with the port's engine behind them on the CPU.

The cases of tests/test_wire_capi.py, test_server.py, test_cluster.py
and test_go_sdk_wire.py, run against the port's modules (the wire
goldens of the Go SDK, go/gamma/testdata, emitted byte for byte by the
port's wire), the TexMex readers of the port's utils/datasets.py, one
case that serves the same requests through both packages' servers and
compares the answers, and the device seam of the port's c_api: engines
that Init creates take the module default (`set_default_device`),
which is the card, so without one Init raises unless "cpu" is set.
Every engine here runs on the CPU by that default, set for the module
and put back afterwards."""

import json
import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from gamma_tpu_torch import c_api
from gamma_tpu_torch.api.doc import Doc
from gamma_tpu_torch.api.request import (Request, RangeFilter, TermFilter,
                                         VectorQuery)
from gamma_tpu_torch.api.response import (Response, ResultItem,
                                          SearchResult, SearchResultCode)
from gamma_tpu_torch.api.status import EngineStatus, IndexStatus
from gamma_tpu_torch.cluster import GammaRouter, launch_local
from gamma_tpu_torch.config import (DataType, EngineConfig, FieldInfo,
                                    TableInfo, VectorInfo)
from gamma_tpu_torch.idl import wire
from gamma_tpu_torch.server import GammaClient, ServerError, serve
from gamma_tpu_torch.utils import datasets

from conftest import make_blobs

TESTDATA = Path(__file__).resolve().parent.parent / "go" / "gamma" / "testdata"


@pytest.fixture(scope="module", autouse=True)
def cpu_engines():
    old = c_api.set_default_device("cpu")
    yield
    c_api.set_default_device(old)


# ---- the device seam ----

def test_init_needs_a_card_or_cpu(tmp_path, monkeypatch):
    cfg = wire.pack_config(EngineConfig(path=str(tmp_path)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    old = c_api.set_default_device(None)
    try:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            c_api.Init(cfg)
        h = c_api.Init(cfg, device="cpu")
    finally:
        c_api.set_default_device(old)
    assert c_api._get(h).device.type == "cpu"
    assert c_api.Close(h) == 0
    h = c_api.Init(cfg)                          # the module default
    assert c_api._get(h).device.type == "cpu"
    assert c_api.Close(h) == 0


# ---- tests/test_wire_capi.py on the port ----

def test_request_roundtrip():
    q = np.random.default_rng(30).normal(size=(4, 16)).astype(np.float32)
    req = Request(
        topn=7, req_num=4,
        vec_fields=[VectorQuery("vec", q, min_score=0.1, boost=2.0,
                                has_boost=True)],
        fields=["a", "b"],
        range_filters=[RangeFilter("price", 1.0, 9.0,
                                   include_upper=False)],
        term_filters=[TermFilter("tag", ["x", "y"], is_union=0)],
        retrieval_params={"nprobe": 5, "metric_type": "L2"},
        brute_force_search=True, l2_sqrt=True)
    out = wire.unpack_request(wire.pack_request(req))
    np.testing.assert_array_equal(out.vec_fields[0].value, q)
    assert out.topn == 7 and out.req_num == 4
    assert out.vec_fields[0].min_score == pytest.approx(0.1)
    assert out.vec_fields[0].max_score == float("inf")
    assert out.vec_fields[0].boost == 2.0 and out.vec_fields[0].has_boost
    assert out.range_filters[0].upper_value == 9.0
    assert not out.range_filters[0].include_upper
    assert out.term_filters[0].terms() == ["x", "y"]
    assert out.term_filters[0].is_union == 0
    assert out.retrieval_params["nprobe"] == 5
    assert out.brute_force_search and out.l2_sqrt


def test_docs_response_status_roundtrip():
    rng = np.random.default_rng(31)
    docs = [Doc(key=f"k{i}", fields={"price": float(i), "tag": "t"},
                vectors={"vec": rng.normal(size=8).astype(np.float32)})
            for i in range(3)]
    out = wire.unpack_docs(wire.pack_docs(docs))
    assert [d.key for d in out] == ["k0", "k1", "k2"]
    np.testing.assert_allclose(out[2].vectors["vec"],
                               docs[2].vectors["vec"])
    resp = Response(results=[SearchResult(
        total=1, result_items=[ResultItem(score=0.5, docid=3, key="k3",
                                          attributes={"p": 1.5})])],
        online_log_message="t")
    got = wire.unpack_response(wire.pack_response(resp))
    assert got.results[0].result_items[0].key == "k3"
    assert got.results[0].result_items[0].attributes["p"] == 1.5
    st = wire.unpack_status(wire.pack_status(
        EngineStatus(index_status=IndexStatus.INDEXED, doc_count=9)))
    assert st.index_status == IndexStatus.INDEXED and st.doc_count == 9


def test_bad_wire_data():
    with pytest.raises(ValueError):
        wire.unpack_request(b"\x00" * 32)
    with pytest.raises(ValueError):
        wire.unpack_request(wire.pack_docs([]))     # wrong message type


def _ivfpq_table(name="t", dim=16, indexing_size=500, vec="vec"):
    return TableInfo(
        name=name, fields=[FieldInfo("price", DataType.FLOAT, True)],
        vectors=[VectorInfo(vec, dim)], indexing_size=indexing_size,
        retrieval_types=["IVFPQ"],
        retrieval_params=[{"ncentroids": 16, "nsubvector": 4}])


def test_c_api_lifecycle(tmp_path):
    rng = np.random.default_rng(32)
    cfg = wire.pack_config(EngineConfig(path=str(tmp_path)))
    h = c_api.Init(cfg)
    assert c_api.CreateTable(h, wire.pack_table(_ivfpq_table())) == 0
    x = rng.normal(size=(800, 16)).astype(np.float32)
    docs = [Doc(key=f"k{i}", fields={"price": float(i)},
                vectors={"vec": x[i]}) for i in range(800)]
    codes = wire.unpack_batch_result(
        c_api.AddOrUpdateDocs(h, wire.pack_docs(docs)))
    assert all(c == 0 for c in codes)
    c_api.BuildIndex(h)
    c_api.Flush(h)
    st = wire.unpack_status(c_api.GetEngineStatus(h))
    assert st.index_status == IndexStatus.INDEXED and st.doc_count == 800
    req = Request(topn=3, vec_fields=[VectorQuery("vec", x[5])],
                  fields=["price"])
    resp = wire.unpack_response(c_api.Search(h, wire.pack_request(req)))
    assert resp.results[0].result_items[0].key == "k5"
    doc9 = wire.unpack_doc(c_api.GetDocByID(h, b"k9"))
    assert doc9.fields["price"] == 9.0
    np.testing.assert_allclose(doc9.vectors["vec"], x[9], atol=1e-6)
    assert c_api.DeleteDoc(h, b"k5") == 0
    assert c_api.DeleteDoc(h, b"k5") == -1
    assert c_api.GetDocByID(h, b"k5") is None
    cfg2 = wire.unpack_config(c_api.GetConfig(h))
    assert cfg2.path == str(tmp_path)
    cfg2.max_concurrent = 7
    assert c_api.SetConfig(h, wire.pack_config(cfg2)) == 0
    assert c_api._get(h).config.max_concurrent == 7
    assert c_api.Dump(h) == 0
    assert c_api.Close(h) == 0
    assert c_api.Close(h) == -1
    h2 = c_api.Init(cfg)                        # reload through the surface
    assert c_api.Load(h2) == 0
    resp = wire.unpack_response(c_api.Search(h2, wire.pack_request(
        Request(topn=1, vec_fields=[VectorQuery("vec", x[7])]))))
    assert resp.results[0].result_items[0].key == "k7"
    c_api.Close(h2)


def test_capi_full_surface_parity(tmp_path):
    """GetDocByDocID, DelDocByFilter, the staged-ingest trio
    (PrepareDocs / AddOrUpdateDocsNum / AddOrUpdateDocsFinish) and the
    migration calls."""
    h = c_api.Init(wire.pack_config(EngineConfig(path=str(tmp_path))))
    c_api.CreateTable(h, wire.pack_table(_ivfpq_table(
        indexing_size=10_000, vec="emb")))
    x = np.random.default_rng(0).normal(size=(60, 16)).astype(np.float32)
    docs = [Doc(key=f"k{i}", fields={"price": float(i)},
                vectors={"emb": x[i]}) for i in range(60)]
    assert c_api.PrepareDocs(h, wire.pack_docs(docs)) == 0
    assert c_api.AddOrUpdateDocsNum(h, 25) == 0
    assert c_api.AddOrUpdateDocsFinish(h) == 0
    assert c_api.AddOrUpdateDocsFinish(h) == -1      # nothing staged
    c_api.Flush(h)
    assert wire.unpack_status(c_api.GetEngineStatus(h)).doc_count == 60
    d7 = wire.unpack_doc(c_api.GetDocByDocID(h, 7))
    assert d7.key == "k7" and d7.fields["price"] == 7.0
    assert c_api.GetDocByDocID(h, 10_000) is None
    n = c_api.DelDocByFilter(h, wire.pack_request(Request(
        range_filters=[RangeFilter("price", 0.0, 4.0)])))
    assert n == 5
    assert c_api.GetDocByID(h, b"k2") is None
    assert c_api.BeginMigrate(h) == 0
    got = c_api.GetMigrateDoc(h, 100)
    assert len(got) == 55 and c_api.TerminateMigrate(h) == 0   # live docs
    c_api.Close(h)


# ---- tests/test_server.py on the port ----

def test_server_lifecycle(tmp_path):
    rng = np.random.default_rng(33)
    addr = os.path.join(str(tmp_path), "gamma.sock")
    srv = serve(addr)
    try:
        cli = GammaClient(addr)
        assert cli.init(EngineConfig(path=str(tmp_path / "db"))) == 0
        assert cli.create_table(_ivfpq_table(indexing_size=400)) == 0
        x = rng.normal(size=(600, 16)).astype(np.float32)
        codes = cli.add_or_update_docs([
            Doc(key=f"k{i}", fields={"price": float(i)},
                vectors={"vec": x[i]}) for i in range(600)])
        assert all(c == 0 for c in codes)
        cli.build_index()
        cli.flush()
        st = cli.status()
        assert st.doc_count == 600 and st.index_status.name == "INDEXED"
        resp = cli.search(Request(
            topn=3, vec_fields=[VectorQuery("vec", x[5])],
            fields=["price"]))
        assert resp.results[0].result_items[0].key == "k5"
        resp2 = cli.search(Request(
            topn=5, vec_fields=[VectorQuery("vec", x[5])],
            range_filters=[RangeFilter("price", 100.0, 200.0)]))
        for it in resp2.results[0].result_items:
            assert 100 <= it.docid <= 200
        assert cli.get_doc("k9").fields["price"] == 9.0
        assert cli.get_doc("missing") is None
        assert cli.delete("k5") == 0
        assert cli.delete("k5") == -1
        assert cli.dump() == 0
        cli.close()
        cli2 = GammaClient(addr)        # a fresh handle loads the dump
        cli2.init(EngineConfig(path=str(tmp_path / "db")))
        assert cli2.load() == 0
        r = cli2.search(Request(topn=1,
                                vec_fields=[VectorQuery("vec", x[7])]))
        assert r.results[0].result_items[0].key == "k7"
        cli2.close()
    finally:
        srv.stop()


def test_server_error_paths_and_restart(tmp_path):
    addr = os.path.join(str(tmp_path), "g.sock")
    srv = serve(addr)
    cli = GammaClient(addr)
    with pytest.raises(ServerError):
        cli.search(Request(topn=1))
    cli.close()
    srv.stop()
    srv2 = serve(addr)                  # the socket path is reusable
    cli2 = GammaClient(addr)
    assert cli2.init(EngineConfig(path=str(tmp_path / "db2"))) == 0
    cli2.close()
    srv2.stop()


def test_tcp_server_on_an_ephemeral_port(tmp_path):
    """serve(("127.0.0.1", 0)) binds a free port; the client reaches it
    over TCP."""
    srv = serve(("127.0.0.1", 0))
    try:
        cli = GammaClient(srv.server_address)
        assert cli.init(EngineConfig(path=str(tmp_path / "db"))) == 0
        assert cli.status().doc_count == 0
        cli.close()
    finally:
        srv.stop()


def test_faisslike_deletions_survive_reload(tmp_path):
    from gamma_tpu_torch.faisslike import IndexFlat
    x = make_blobs(np.random.default_rng(34), 2000, 32)
    idx = IndexFlat(32, device="cpu")
    idx.add(x)
    idx.remove_ids(np.array([0, 10**9, -5]))   # OOR ids ignored
    idx.dump(str(tmp_path))
    idx2 = IndexFlat(32, device="cpu")
    idx2.load(str(tmp_path))
    _, I = idx2.search(x[:1], k=3)
    assert 0 not in I[0]


def test_both_servers_answer_alike(tmp_path):
    """The same requests over the frame protocol to the JAX package's
    server and to the port's, each with a FLAT engine (exact, so the
    answers must agree): equal keys and attributes, scores to 1e-5,
    equal status, documents and delete codes."""
    from gamma_tpu import server as jserver
    from gamma_tpu.api.request import Request as JRequest
    from gamma_tpu.api.request import RangeFilter as JRangeFilter
    from gamma_tpu.api.request import VectorQuery as JVectorQuery
    x = make_blobs(np.random.default_rng(35), 1500, 16)
    table = TableInfo(
        name="t", fields=[FieldInfo("price", DataType.FLOAT, True)],
        vectors=[VectorInfo("vec", 16)], indexing_size=100,
        retrieval_types=["FLAT"], retrieval_params=[{}])
    docs = [Doc(key=f"k{i}", fields={"price": float(i % 300)},
                vectors={"vec": x[i]}) for i in range(1500)]
    answers = {}
    for name, mod in (("jax", jserver), ("port", None)):
        addr = os.path.join(str(tmp_path), f"{name}.sock")
        srv = (mod.serve if mod else serve)(addr)
        cli = (mod.GammaClient if mod else GammaClient)(addr)
        try:
            rq, rf, vq = ((JRequest, JRangeFilter, JVectorQuery) if mod
                          else (Request, RangeFilter, VectorQuery))
            assert cli.init(EngineConfig(path=str(tmp_path / name))) == 0
            assert cli.create_table(table) == 0
            assert cli.add_or_update_docs(docs) == [0] * 1500
            cli.flush()
            out = [cli.search(rq(topn=10, vec_fields=[vq("vec", x[:20])],
                                 fields=["price"])),
                   cli.search(rq(topn=5, vec_fields=[vq("vec", x[40:44])],
                                 range_filters=[rf("price", 10.0, 90.0)],
                                 fields=["price"]))]
            codes = [cli.delete("k3"), cli.delete("k3")]
            out.append(cli.search(rq(topn=5,
                                     vec_fields=[vq("vec", x[3])])))
            st = cli.status()
            answers[name] = (out, codes, (st.doc_count, st.delete_num),
                             cli.get_doc("k9").fields)
            cli.close()
        finally:
            srv.stop()
    (jout, jcodes, jst, jdoc), (tout, tcodes, tst, tdoc) = (
        answers["jax"], answers["port"])
    assert jcodes == tcodes == [0, -1] and jst == tst and jdoc == tdoc
    for jr, tr in zip(jout, tout):
        assert len(jr.results) == len(tr.results)
        for js, ts in zip(jr.results, tr.results):
            assert [it.key for it in ts.result_items] == \
                [it.key for it in js.result_items]
            assert [it.attributes for it in ts.result_items] == \
                [it.attributes for it in js.result_items]
            np.testing.assert_allclose(
                [it.score for it in ts.result_items],
                [it.score for it in js.result_items], rtol=1e-5, atol=1e-5)
    assert "k3" not in [it.key for it in tout[2].results[0].result_items]


# ---- tests/test_cluster.py on the port ----

D, N = 32, 3000


@pytest.fixture(scope="module")
def corpus():
    return make_blobs(np.random.default_rng(21), N, D, n_clusters=32)


@pytest.fixture(scope="module")
def cluster(cpu_engines, tmp_path_factory, corpus):
    base = tmp_path_factory.mktemp("cluster")
    lc = launch_local(3, str(base / "socks"))
    # partition 0 runs TWO replicas (both served by server 0 — replica
    # isolation is per engine handle, not per process)
    router = GammaRouter([[lc.sockets[0], lc.sockets[1]],
                          [lc.sockets[2]]])
    table = TableInfo(
        name="t", fields=[FieldInfo("price", DataType.FLOAT, True)],
        vectors=[VectorInfo("emb", D)], indexing_size=800,
        retrieval_types=["IVFPQ"],
        retrieval_params=[{"ncentroids": 32, "nsubvector": 8,
                           "nprobe": 16}])
    cfgs = [[EngineConfig(path=str(base / "p0r0")),
             EngineConfig(path=str(base / "p0r1"))],
            [EngineConfig(path=str(base / "p1r0"))]]
    router.bootstrap(cfgs, table)
    docs = [Doc(key=f"k{i}", fields={"price": float(i % 500)},
                vectors={"emb": corpus[i]}) for i in range(N)]
    for s in range(0, N, 500):
        router.add_or_update_docs(docs[s:s + 500])
    router.build_index()
    router.flush()
    yield router, base, lc, cfgs
    router.close()
    lc.stop_all()


def test_doc_count_and_placement(cluster):
    router, *_ = cluster
    assert len(router.status()) == 2
    assert router.doc_count() == N
    pi = router.partition_of("k17")
    assert router.get_doc("k17") is not None and 0 <= pi < 2


def test_search_merge_matches_global_topk(cluster, corpus):
    router, *_ = cluster
    q = corpus[42]
    items = router.search(Request(
        topn=10, vec_fields=[VectorQuery("emb", q)])).results[0].result_items
    assert items[0].key == "k42"
    scores = [it.score for it in items]
    assert scores == sorted(scores) and len(items) == 10
    d2 = np.sum((corpus - q) ** 2, axis=1)
    assert {f"k{i}" for i in np.argsort(d2)[:3]} <= {it.key for it in items}


def test_filters_cross_partition(cluster, corpus):
    router, *_ = cluster
    resp = router.search(Request(
        topn=10, vec_fields=[VectorQuery("emb", corpus[10])],
        range_filters=[RangeFilter("price", 0.0, 99.0)]))
    for it in resp.results[0].result_items:
        assert 0.0 <= it.attributes.get("price", 0.0) <= 99.0 or \
            it.attributes == {}


def test_delete_routed(cluster, corpus):
    router, *_ = cluster
    assert router.delete("k77") == 0
    resp = router.search(Request(
        topn=5, vec_fields=[VectorQuery("emb", corpus[77])]))
    assert all(it.key != "k77" for it in resp.results[0].result_items)
    assert router.get_doc("k77") is None


def test_replica_failover_and_recovery(cluster, corpus):
    router, base, lc, cfgs = cluster
    lc.stop(0)
    router._drop_client(0, 0)
    q = corpus[100]
    resp = router.search(Request(topn=5, vec_fields=[VectorQuery("emb", q)]))
    assert resp.results[0].result_items
    assert router.partitions[0].alive == [False, True]
    # a write onto partition 0 while replica 0 is dead shows as its lag
    for i in range(50):
        key = f"lagprobe{i}"
        if router.partition_of(key) == 0:
            router.add_or_update_docs([Doc(
                key=key, fields={"price": 1.0},
                vectors={"emb": corpus[1] + 0.02})])
            break
    assert router.replica_status()[0]["lag"][0] >= 1
    router.recover_replica(
        0, 0, new_addr=lc.sockets[1],
        new_config=EngineConfig(path=str(base / "p0r0_recovered")),
        source_path=str(base / "p0r1"),
        dest_path=str(base / "p0r0_recovered"))
    assert router.partitions[0].alive == [True, True]
    assert router.replica_status()[0]["lag"] == [0, 0]
    resp = router.search(Request(topn=5, vec_fields=[VectorQuery("emb", q)]))
    assert resp.results[0].result_items


# ---- tests/test_go_sdk_wire.py on the port ----

_VEC = np.arange(8, dtype=np.float32) / 4.0
_VEC2 = np.linspace(-1.0, 1.0, 8).astype(np.float32)


def _golden_docs() -> bytes:
    return wire.pack_docs([
        Doc(key="doc-1", fields={"color": "red", "price": 9},
            vectors={"emb": _VEC}),
        Doc(key=7, fields={}, vectors={"emb": _VEC2}),
    ])


def _golden_request() -> bytes:
    return wire.pack_request(Request(
        topn=5, req_num=1,
        vec_fields=[VectorQuery(name="emb", value=_VEC, min_score=-np.inf,
                                max_score=np.inf, boost=1.0,
                                has_boost=False)],
        range_filters=[RangeFilter(field="price", lower_value=1,
                                   upper_value=10, include_lower=True,
                                   include_upper=False)],
        term_filters=[TermFilter(field="color", value=["red", "blue"],
                                 is_union=1)],
        retrieval_params={"nprobe": 16},
        fields=["color"],
    ))


@pytest.mark.parametrize("name,make", [("docs.bin", _golden_docs),
                                       ("request.bin", _golden_request)])
def test_goldens_current(name, make):
    """The port's wire emits the checked-in Go goldens byte for byte."""
    assert (TESTDATA / name).read_bytes() == make()


def _go_style_pack(msg_type: int, header: dict, blobs) -> bytes:
    """What go/gamma/gamma.go WirePack emits: JSON via json.Marshal
    (sorted keys, no spaces), then the GWIR framing."""
    hj = json.dumps(header, separators=(",", ":"), sort_keys=True).encode()
    out = [struct.pack("<IBBHI", wire.MAGIC, wire.VERSION, msg_type, 0,
                       len(hj)), hj, struct.pack("<I", len(blobs))]
    for b in blobs:
        out += [struct.pack("<I", len(b)), b]
    return b"".join(out)


def test_go_style_docs_and_request_parse():
    blob = _VEC.tobytes()
    docs = wire.unpack_docs(_go_style_pack(wire.MSG_DOCS, {"docs": [{
        "fields": {"color": "red", "price": 9}, "key": "doc-1",
        "vectors": {"emb": {"$blob": 0, "dtype": "float32",
                            "shape": [8]}}}]}, [blob]))
    assert len(docs) == 1 and docs[0].key == "doc-1"
    assert docs[0].fields == {"color": "red", "price": 9}
    np.testing.assert_array_equal(docs[0].vectors["emb"], _VEC)
    got = wire.unpack_request(_go_style_pack(wire.MSG_REQUEST, {
        "brute_force_search": False, "fields": ["color"],
        "l2_sqrt": False, "multi_vector_rank": 0, "online_log_level": "",
        "range_filters": [{"field": "price", "include_lower": True,
                           "include_upper": False, "lower_value": 1,
                           "upper_value": 10}],
        "req_num": 1, "retrieval_params": {"nprobe": 16},
        "term_filters": [{"field": "color", "is_union": 1,
                          "value": ["red", "blue"]}],
        "topn": 5,
        "vec_fields": [{"boost": 1.0, "has_boost": False,
                        "max_score": None, "min_score": None,
                        "name": "emb",
                        "value": {"$blob": 0, "dtype": "float32",
                                  "shape": [8]}}]}, [blob]))
    want = wire.unpack_request(_golden_request())
    assert got.topn == want.topn == 5
    assert got.retrieval_params == want.retrieval_params
    assert [rf.__dict__ for rf in got.range_filters] == \
           [rf.__dict__ for rf in want.range_filters]
    assert [tf.terms() for tf in got.term_filters] == \
           [tf.terms() for tf in want.term_filters]
    assert got.vec_fields[0].min_score == -np.inf
    assert got.vec_fields[0].max_score == np.inf
    np.testing.assert_array_equal(got.vec_fields[0].value,
                                  want.vec_fields[0].value)


def test_go_response_and_status_fields():
    """The response and status JSON carry the keys the Go structs
    decode (json tags in gamma.go)."""
    resp = Response(results=[SearchResult(
        total=3, result_code=SearchResultCode.SUCCESS, msg="",
        result_items=[ResultItem(score=0.25, docid=4, key="doc-1",
                                 attributes={"color": "red"})])])
    h, _ = wire._unpack(wire.pack_response(resp), wire.MSG_RESPONSE)
    assert set(h) == {"online_log_message", "results"}
    assert set(h["results"][0]) == {"total", "result_code", "msg", "items"}
    assert set(h["results"][0]["items"][0]) == {"score", "docid", "key",
                                                "attributes"}
    st = EngineStatus(index_status=IndexStatus.INDEXED, doc_count=42,
                      max_docid=41, delete_num=1)
    h, _ = wire._unpack(wire.pack_status(st), wire.MSG_STATUS)
    for key in ("index_status", "table_mem_bytes", "index_mem_bytes",
                "vector_mem_bytes", "field_range_mem_bytes",
                "bitmap_mem_bytes", "doc_count", "max_docid",
                "min_indexed_num", "delete_num"):
        assert key in h, key
    assert h["index_status"] == 2 and h["doc_count"] == 42


# ---- tests/test_datasets.py on the port ----

def test_texmex_roundtrip(tmp_path):
    rng = np.random.default_rng(36)
    x = rng.normal(size=(100, 17)).astype(np.float32)
    g = rng.integers(0, 1 << 20, size=(32, 100)).astype(np.int32)
    datasets.write_fvecs(str(tmp_path / "x.fvecs"), x)
    datasets.write_ivecs(str(tmp_path / "g.ivecs"), g)
    np.testing.assert_array_equal(
        datasets.read_fvecs(str(tmp_path / "x.fvecs"), count=5,
                            offset_rows=90), x[90:95])
    np.testing.assert_array_equal(
        datasets.read_ivecs(str(tmp_path / "g.ivecs")), g)
