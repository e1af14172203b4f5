"""The frozen generator and the traffic generator."""

import numpy as np
import torch

from gpubench import corpus, traffic

CFG = {"corpus": {"n": 5000, "d": 16, "clusters": 32, "intrinsic": 4,
                  "noise": 0.05},
       "queries": {"pool": 300, "noise": 0.5}}


def test_same_seed_same_data():
    a = corpus.make(CFG, 2**31 + 5, "cpu")
    b = corpus.make(CFG, 2**31 + 5, "cpu")
    for x, y in ((a.corpus, b.corpus), (a.queries, b.queries),
                 (a.keys, b.keys)):
        assert torch.equal(x, y)


def test_other_seed_other_data():
    a = corpus.make(CFG, 1, "cpu")
    b = corpus.make(CFG, 2, "cpu")
    assert not torch.equal(a.corpus, b.corpus)
    assert not torch.equal(a.keys, b.keys)


def test_shapes_and_keys():
    a = corpus.make(CFG, 3, "cpu")
    assert a.corpus.shape == (5000, 16) and a.corpus.dtype == torch.float32
    assert a.queries.shape == (300, 16)
    k = a.keys.numpy() - corpus.KEY_BASE
    assert np.array_equal(np.sort(k), np.arange(5000))


def test_requests_walk_the_pool():
    rows = [traffic.rows(i, 128, 300) for i in range(5)]
    flat = np.concatenate(rows)
    assert np.array_equal(flat, np.arange(640) % 300)
    cfg = {"search_params": {"nprobe": 40, "recall_num": 100}}
    t = {"kind": "closed_loop", "retrieval_params": {"scan_mode": "gather",
                                                     "nprobe": 8}}
    assert traffic.retrieval_params(cfg, t) == {
        "nprobe": 8, "recall_num": 100, "scan_mode": "gather"}
