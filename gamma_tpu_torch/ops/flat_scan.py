"""Brute-force scan: exact top-k with fused validity penalty (counterpart
of gamma_tpu/ops/flat_scan.py).

One distance GEMM per corpus chunk plus a running top-k merge; the
penalty add replaces the reference's IsValid callback and the score
range masks in-scan so the top-k fills with in-range hits.  This is the
IVFPQ model's pre-training fallback.
"""

from __future__ import annotations

import torch

from gamma_tpu_torch.ops.distances import BIG, pairwise_ip, pairwise_l2
from gamma_tpu_torch.ops.topk import merge_topk, topk_min


def flat_search(vectors: torch.Tensor, vec_norms: torch.Tensor,
                queries: torch.Tensor, penalty: torch.Tensor,
                dist_range: torch.Tensor = None,
                *, k: int, metric: str = "l2", chunk: int = 131072):
    """Exact search over `vectors` [N_cap, d] (bf16 or f32; rows past the
    live count are masked by penalty=BIG) with precomputed norms
    [N_cap] (ignored for IP), queries [B, d], penalty [N_cap], and an
    optional [2] f32 distance range.
    → (dists [B, k] f32, ids [B, k] int64); masked slots come back with
    dist >= BIG — callers drop them."""
    n = vectors.shape[0]
    b = queries.shape[0]
    dev = queries.device
    best_d = torch.full((b, k), BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        v = vectors[s:s + chunk]
        if metric == "ip":
            d = -pairwise_ip(queries, v)
        else:
            d = pairwise_l2(queries, v, vec_norms[s:s + chunk])
        if dist_range is not None:
            d = torch.where((d < dist_range[0]) | (d > dist_range[1]),
                            BIG, d)
        d = torch.clamp_max(d + penalty[None, s:s + chunk], BIG)
        ids = torch.arange(s, s + v.shape[0], device=dev).expand(b, -1)
        cd, ci = topk_min(d, ids, k)
        best_d, best_i = merge_topk(best_d, best_i, cd, ci, k)
    return best_d, best_i
