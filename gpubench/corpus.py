"""The frozen corpus generator: SIFT-geometry synthetic vectors from a seed.

A copy, in PyTorch, of the generator bench.py validated against the
upstream nprobe curve (docs/nprobe_curve.md): points on a manifold of low
intrinsic dimension (real SIFT's is about 12 to 16), drawn around
Gaussian cluster centres and embedded in d dimensions with small ambient
noise.  Every row draws its own cluster, so the rows come in no cluster
order and need no shuffle.  Queries are corpus rows plus isotropic noise.

It runs where the generator lives (a `torch.Generator` on the card, in a
few large calls) and is the same for the same seed and device; it is
frozen: a change here changes every cell's data.
"""

from __future__ import annotations

import dataclasses
import math

import torch

CHUNK = 262_144          # rows drawn per call
KEY_BASE = 1_000_000_000  # doc keys are KEY_BASE + a permutation of rows


@dataclasses.dataclass
class Data:
    corpus: torch.Tensor     # [n, d] float32
    queries: torch.Tensor    # [pool, d] float32
    keys: torch.Tensor       # [n] int64, the doc key of each row


def make(cfg: dict, seed: int, device) -> Data:
    """The corpus, query pool and doc keys of configuration `cfg`
    (`corpus`: n, d, clusters, intrinsic, noise; `queries`: pool,
    noise) from `seed`."""
    c, qc = cfg["corpus"], cfg["queries"]
    n, d, intr = int(c["n"]), int(c["d"]), int(c["intrinsic"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    basis = randn(intr, d) / math.sqrt(intr)
    centers = randn(int(c["clusters"]), intr) * 4.0
    corpus = torch.empty(n, d, device=device)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        a = torch.randint(0, centers.shape[0], (e - s,), generator=g,
                          device=device)
        z = centers[a] + randn(e - s, intr)
        corpus[s:e] = z @ basis + float(c["noise"]) * randn(e - s, d)
    pool = int(qc["pool"])
    rows = torch.randperm(n, generator=g, device=device)[:pool]
    queries = corpus[rows] + float(qc["noise"]) * randn(pool, d)
    keys = KEY_BASE + torch.randperm(n, generator=g, device=device)
    return Data(corpus, queries, keys)
