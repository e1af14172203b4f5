"""The plain reference and the comparison on hand-made cases."""

import numpy as np

from gpubench import check
from gpubench.corpus import KEY_BASE
from gpubench.reference import exact


def _case():
    corpus = np.array([[0, 0], [1, 0], [0, 2], [3, 3], [-1, -1]],
                      np.float32)
    queries = np.array([[0.1, 0], [2.9, 3.2]], np.float32)
    return corpus, queries


def test_exact_topk_by_hand():
    corpus, queries = _case()
    ref = exact.Exact(corpus, queries, "cpu")
    d, rows = ref.topk(3)
    assert rows.tolist() == [[0, 1, 4], [3, 2, 1]]
    assert np.allclose(d[0], [0.01, 0.81, 2.21])
    assert np.allclose(d[1], [0.05, 9.85, 13.85])


def test_blocks_change_nothing(monkeypatch):
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(1000, 8)).astype(np.float32)
    queries = rng.normal(size=(50, 8)).astype(np.float32)
    whole = exact.Exact(corpus, queries, "cpu").topk(10)
    monkeypatch.setattr(exact, "ROW_BLOCK", 97)
    monkeypatch.setattr(exact, "Q_BLOCK", 7)
    blocked = exact.Exact(corpus, queries, "cpu").topk(10)
    assert np.array_equal(whole[1], blocked[1])
    full = ((queries[:, None, :].astype(np.float64) - corpus[None]) ** 2
            ).sum(-1)
    assert np.array_equal(np.argsort(full, 1)[:, :10], whole[1])


def test_pair_dist():
    corpus, queries = _case()
    ref = exact.Exact(corpus, queries, "cpu")
    d = ref.pair_dist(np.array([0, 1, 1]), np.array([1, 3, -1]))
    assert np.allclose(d[:2], [0.81, 0.05]) and np.isnan(d[2])


def _answers(perm):
    """Exact answers of the hand-made case as the engine would pack them,
    keys KEY_BASE + perm[row]."""
    corpus, queries = _case()
    ref = exact.Exact(corpus, queries, "cpu")
    d, rows = ref.topk(2)
    keys = (KEY_BASE + perm[rows]).astype(np.float64)
    row_of_key = np.empty_like(perm)
    row_of_key[perm] = np.arange(perm.size)
    return ref, keys, d.astype(np.float32).astype(np.float64), row_of_key


def test_compare_exact_answers_pass():
    perm = np.array([3, 0, 4, 1, 2])
    ref, keys, scores, row_of_key = _answers(perm)
    limits = {"bad_answers": {"limit": 0}, "score_gap": {"limit": 1e-6}}
    nums, recall = check.compare(np.array([0, 1]), keys, scores, row_of_key,
                                 ref, 2, limits)
    assert recall == 1.0 and check.passed(nums)
    assert nums["bad_answers"]["value"] == 0
    assert nums["recall_gap"]["limit"] is None


def test_compare_catches_each_fault():
    perm = np.array([3, 0, 4, 1, 2])
    limits = {"bad_answers": {"limit": 0}, "score_gap": {"limit": 1e-3}}
    rows = np.array([0, 1])
    for fault in ("key", "missing", "twice", "order", "unknown", "inf",
                  "all_inf"):
        ref, keys, scores, row_of_key = _answers(perm)
        if fault == "key":           # a hit's key altered, score kept
            keys[0, 1] = KEY_BASE + perm[3]
        elif fault == "missing":
            keys[1, 1], scores[1, 1] = -1, np.nan
        elif fault == "twice":
            keys[0, 1], scores[0, 1] = keys[0, 0], scores[0, 0]
        elif fault == "order":
            scores[0] = scores[0, ::-1]
        elif fault == "inf":         # one hit's score overflowed
            scores[1, 1] = np.inf
        elif fault == "all_inf":     # every score inf, still "in order"
            scores[:] = np.inf
        else:
            keys[1, 0] = KEY_BASE + 99
        nums, _ = check.compare(rows, keys, scores, row_of_key, ref, 2,
                                limits)
        assert not check.passed(nums), fault
