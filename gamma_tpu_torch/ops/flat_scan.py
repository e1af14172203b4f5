"""Brute-force scan: exact top-k with fused validity penalty (counterpart
of gamma_tpu/ops/flat_scan.py).

One distance GEMM per corpus chunk plus a running top-k merge; the
penalty add replaces the reference's IsValid callback and the score
range masks in-scan so the top-k fills with in-range hits.  This is the
IVF models' pre-training fallback.  `flat_search_streaming` scans a
corpus that lives on the host (the disk tier holds no device mirror):
chunks go through the card one after another.
"""

from __future__ import annotations

import numpy as np
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


def _stream_chunk(rows, rnorms, pen, start, best_d, best_i, queries,
                  dist_range=None, *, k: int, metric: str):
    """One uploaded chunk's distances merged into the running top-k."""
    if metric == "ip":
        d = -pairwise_ip(queries, rows)
    else:
        d = pairwise_l2(queries, rows, rnorms)
    if dist_range is not None:
        d = torch.where((d < dist_range[0]) | (d > dist_range[1]), BIG, d)
    d = torch.clamp_max(d + pen[None, :], BIG)
    ids = torch.arange(start, start + rows.shape[0],
                       device=d.device).expand(d.shape[0], -1)
    cd, ci = topk_min(d, ids, k)
    return merge_topk(best_d, best_i, cd, ci, k)


def flat_search_streaming(host, n: int, queries: torch.Tensor, pen_rows,
                          dist_range: torch.Tensor = None, *, k: int,
                          metric: str = "l2", chunk: int = 65536):
    """Exact scan over a HOST-resident corpus (the disk tier: no device
    mirror, reference vector/rocksdb_raw_vector.cc): chunks of `host`
    (any row-sliceable array, np.memmap and float16 included) are
    widened to f32, uploaded once each and scanned on the card against
    a running top-k.  Row norms are taken on the host in float64.
    `pen_rows` is the row-aligned penalty (tensor or array); rows past
    its end are masked.  The chunk length follows the JAX package's
    ladder (1024, 4096, ... up to `chunk`), so ties break alike.
    → (dists [B, k] f32, ids [B, k] int64)."""
    b = queries.shape[0]
    dev = queries.device
    best_d = torch.full((b, k), BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    if n <= 0:
        return best_d, best_i
    q = 1024
    while q < n and q < chunk:
        q *= 4
    chunk = min(chunk, q)
    pen = (pen_rows.detach().cpu().numpy() if torch.is_tensor(pen_rows)
           else np.asarray(pen_rows))
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        rows_np = np.zeros((chunk, host.shape[1]), np.float32)
        rows_np[: e - s] = host[s:e]
        pen_c = np.full((chunk,), BIG, np.float32)
        m = pen[s: min(e, pen.size)]
        pen_c[: m.size] = m
        norms = np.sum(rows_np.astype(np.float64) ** 2, axis=1).astype(
            np.float32)
        best_d, best_i = _stream_chunk(
            torch.from_numpy(rows_np).to(dev), torch.from_numpy(norms).to(dev),
            torch.from_numpy(pen_c).to(dev), s, best_d, best_i, queries,
            dist_range, k=k, metric=metric)
    return best_d, best_i
