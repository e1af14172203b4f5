"""The storage contracts of tests/test_zblock.py and
tests/test_native_persist.py, run through both packages on the same
docs: the zstd block store (native ZStore: torn-frame recovery, and an
engine with zstd-compressed table columns and vector segments through
dump and restart) and native incremental persistence (dump = sync +
commit marker, commit recovery with updates and deletes, a kill between
flushes truncated to the commit, the trained index in the commit).

Each test runs one contract on a `gamma_tpu` engine and on a
`gamma_tpu_torch` engine (on the CPU by request), asserts the contract
on each, and then that both answer alike: the same ids (ids that tie
may come in either order), and scores to 1e-3 relative and 1e-3
absolute (both scan bf16 mirrors in f32, in other summation orders).
The 1M-row restore speed test stays the JAX package's own
(tests/test_native_persist.py)."""

import os

import numpy as np
import pytest

import gamma_tpu
import gamma_tpu_torch

PKGS = [gamma_tpu, gamma_tpu_torch]
DIM = 16

pytestmark = pytest.mark.skipif(
    not (gamma_tpu_torch.native.available()
         or gamma_tpu_torch.native.build()),
    reason="libgamma_host.so unavailable")


def _open(pkg, path, **cfg):
    kw = {"device": "cpu"} if pkg is gamma_tpu_torch else {}
    return pkg.GammaEngine(pkg.EngineConfig(path=str(path), **cfg), **kw)


def _flat_engine(pkg, path, store_param=None, **cfg):
    """test_native_persist.make_engine: untrained FLAT, two indexed
    scalar fields."""
    eng = _open(pkg, path, **cfg)
    dt = pkg.config.DataType
    eng.create_table(pkg.TableInfo(
        name="np1",
        fields=[pkg.FieldInfo("price", dt.FLOAT, is_index=True),
                pkg.FieldInfo("tag", dt.STRING, is_index=True)],
        vectors=[pkg.VectorInfo("vec", DIM,
                                store_param=dict(store_param or {}))],
        indexing_size=100_000,
        retrieval_types=["FLAT"], retrieval_params=[{}]))
    assert eng._native_persist
    return eng


def _add(pkg, eng, x, lo, hi, key="k"):
    assert all(c == 0 for c in eng.add_or_update_docs([
        pkg.Doc(key=f"{key}{i}", fields={"price": float(i),
                                         "tag": f"t{i % 3}"},
                vectors={"vec": x[i]}) for i in range(lo, hi)]))


def _answers(pkg, eng, q, topn=3, **kw):
    res = eng.search(pkg.Request(topn=topn, vec_fields=[
        pkg.VectorQuery("vec", q)], **kw)).results
    return ([[it.docid for it in sr.result_items] for sr in res],
            np.array([[it.score for it in sr.result_items] for sr in res]))


def _same_answers(got):
    """The same ids per query (in any order: a doc and its copy under
    another key tie), the same scores in rank order."""
    (ji, jd), (ti, td) = got[gamma_tpu], got[gamma_tpu_torch]
    assert [sorted(r) for r in ti] == [sorted(r) for r in ji]
    np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-3)


def test_zblock_torn_frame_recovery(tmp_path):
    """A partially written final frame is discarded on reopen; the
    sealed prefix and the synced tail survive, and the store keeps
    working (test_zblock.py), through each package's binding: both read
    back the same rows."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(2500, 16)).astype(np.float32)
    got = {}
    for pkg in PKGS:
        path = tmp_path / pkg.__name__
        z = pkg.native.ZBlockStorage(str(path), "t", row_bytes=64,
                                     rows_per_block=1000)
        z.add(base)
        z.sync()
        z.close()
        with open(path / "t.zblk", "ab") as f:
            f.write(b"\x4b\x4c\x42\x5atorn-frame-garbage")
        z2 = pkg.native.ZBlockStorage(str(path), "t", row_bytes=64,
                                      rows_per_block=1000)
        assert len(z2) == 2500
        z2.add(base[:700])
        got[pkg] = z2.get_range(0, 3200, np.float32).reshape(-1, 16)
        z2.close()
    want = np.concatenate([base, base[:700]])
    for pkg in PKGS:
        np.testing.assert_array_equal(got[pkg], want, err_msg=pkg.__name__)


def test_engine_compressed_persistence_roundtrip(tmp_path):
    """zstd table columns and vector segments: ingest, a point update of
    a sealed row, dump, restart; values and search intact, the vector
    payload on disk as zstd frames (test_zblock.py)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(5000, 4)) @ rng.normal(size=(4, DIM))
         ).astype(np.float32)
    got = {}
    for pkg in PKGS:
        path = tmp_path / pkg.__name__
        eng = _flat_engine(pkg, path, {"compress": "zstd"},
                           compress_table_blocks=True)
        _add(pkg, eng, x, 0, 5000)
        assert eng.add_or_update_doc(pkg.Doc(
            key="k5", fields={"price": 5555.0, "tag": "tz"},
            vectors={"vec": x[7]})) == 0
        eng.flush()
        assert eng.dump() == 0
        assert os.path.getsize(path / "store" / "vec_vec.zblk") > 0
        assert not os.path.exists(path / "store" / "vec_vec.seg0")
        eng.close()

        eng2 = _open(pkg, path, compress_table_blocks=True)
        assert eng2.load() == 0
        assert eng2.table.n == 5000
        doc = eng2.get_doc_by_key("k5")
        assert float(doc["price"]) == 5555.0 and doc["tag"] == "tz"
        ids, d = _answers(pkg, eng2, x[[7, 100, 4321]],
                          brute_force_search=True)
        assert 5 in ids[0][:2]
        got[pkg] = (ids, d)
        eng2.close()
    _same_answers(got)


def test_dump_is_sync_plus_marker(tmp_path):
    """Native dump writes no whole-corpus files: the vector segment
    keeps its inode across dumps, commit.json is written, no legacy
    files (test_native_persist.py)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2000, DIM)).astype(np.float32)
    got = {}
    for pkg in PKGS:
        root = tmp_path / pkg.__name__
        eng = _flat_engine(pkg, root)
        _add(pkg, eng, x, 0, 2000)
        eng.flush()
        assert eng.dump() == 0
        seg = root / "store" / "vec_vec.seg0"
        assert seg.exists() and (root / "commit.json").exists()
        assert not any(f.startswith("dump_") for f in os.listdir(root))
        ino = os.stat(seg).st_ino
        _add(pkg, eng, x, 0, 10, key="extra")
        eng.flush()
        assert eng.dump() == 0
        assert os.stat(seg).st_ino == ino
        assert not any(f.endswith(".rawvec.npy") or f.endswith("table.pkl")
                       for f in os.listdir(root))
        got[pkg] = _answers(pkg, eng, x[[3, 500, 1999]])
        eng.close()
    _same_answers(got)


def test_commit_recovery_roundtrip(tmp_path):
    """An update and a delete persist through dump and restart."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(800, DIM)).astype(np.float32)
    got = {}
    for pkg in PKGS:
        path = tmp_path / pkg.__name__
        eng = _flat_engine(pkg, path)
        _add(pkg, eng, x, 0, 800)
        eng.flush()
        assert eng.add_or_update_doc(pkg.Doc(
            key="k5", fields={"price": 5555.0, "tag": "zz"},
            vectors={"vec": x[7]})) == 0
        assert eng.delete("k9") == 0
        assert eng.dump() == 0
        eng.close()
        eng2 = _flat_engine(pkg, path)
        assert eng2.load() == 0
        st = eng2.engine_status()
        assert st.doc_count == 799 and st.delete_num == 1
        d5 = eng2.get_doc_by_key("k5")
        assert d5["price"] == 5555.0 and d5["tag"] == "zz"
        np.testing.assert_allclose(np.asarray(d5["vec"]), x[7], atol=1e-6)
        assert eng2.get_doc_by_key("k9") is None
        ids, d = _answers(pkg, eng2, x[[42, 7, 9]])
        assert ids[0][0] == 42 and 9 not in ids[2]
        got[pkg] = (ids, d)
        eng2.close()
    _same_answers(got)


def test_kill_between_flushes_truncates_to_commit(tmp_path):
    """Rows flushed after the last dump() are truncated away on restore,
    never a mixture; the tail can be ingested again."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(900, DIM)).astype(np.float32)
    got = {}
    for pkg in PKGS:
        path = tmp_path / pkg.__name__
        eng = _flat_engine(pkg, path)
        _add(pkg, eng, x, 0, 500)
        eng.flush()
        assert eng.dump() == 0               # commit @500
        _add(pkg, eng, x, 500, 900)
        eng.flush()                          # persisted, not committed
        eng2 = _flat_engine(pkg, path)       # no dump(), no close()
        assert eng2.load() == 0
        assert eng2.engine_status().doc_count == 500
        assert eng2.get_doc_by_key("k499") is not None
        assert eng2.get_doc_by_key("k700") is None
        committed = _answers(pkg, eng2, x[[700, 10]])
        _add(pkg, eng2, x, 500, 900)
        eng2.flush()
        assert eng2.engine_status().doc_count == 900
        ids, d = _answers(pkg, eng2, x[[700, 10]], topn=1)
        assert eng2.table.key_by_docid(ids[0][0]) == "k700"
        got[pkg] = (committed[0] + ids, np.concatenate(
            [committed[1][:, :1], d]))
        eng2.close()
        eng.close()
    _same_answers(got)


def test_trained_index_snapshot_in_commit(tmp_path):
    """A trained IVFPQ index restores from the commit's index snapshot;
    both packages' restored engines find each query's doc first and
    report its exact (reranked) distance alike."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2000, DIM)).astype(np.float32)
    got = {}
    for pkg in PKGS:
        path = tmp_path / pkg.__name__
        eng = _open(pkg, path)
        eng.create_table(pkg.TableInfo(
            name="nivf",
            fields=[pkg.FieldInfo("p", pkg.config.DataType.FLOAT)],
            vectors=[pkg.VectorInfo("vec", DIM)], indexing_size=1000,
            retrieval_types=["IVFPQ"],
            retrieval_params=[{"ncentroids": 16, "nsubvector": 4}]))
        assert eng._native_persist
        eng.add_or_update_docs([pkg.Doc(key=f"k{i}", fields={"p": 0.0},
                                        vectors={"vec": x[i]})
                                for i in range(2000)])
        eng.flush()
        assert eng.dump() == 0
        eng.close()
        eng2 = _open(pkg, path)
        assert eng2.load() == 0
        st = eng2.engine_status()
        assert st.doc_count == 2000 and st.min_indexed_num >= 2000
        assert st.index_status.name == "INDEXED"
        ids, d = _answers(pkg, eng2, x[[17, 1234]], topn=1,
                          retrieval_params={"recall_num": 50})
        assert [r[0] for r in ids] == [17, 1234]
        got[pkg] = (ids, d)
        eng2.close()
    _same_answers(got)
