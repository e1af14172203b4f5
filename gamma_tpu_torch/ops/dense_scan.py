"""Dense scan over the reconstruction mirror (counterpart of
gamma_tpu/ops/dense_scan.py).

The ADC distance of a PQ code is the exact L2 distance to its
reconstruction c_list + decode(code), so the coarse pass is one
(B x d x N) matrix product against the mirror [N, d] plus a per-row bias,
then a top-recall_num select and an exact rerank of the candidates
against the store mirror (reference: the recall_num heap → compute_dis
pipeline, gamma_index_ivfpq.cc:642-697).  nprobe does not apply: the
product touches every row.

Differences from the JAX functions, none of which changes a result:
  * the [B, N] scores are never whole: rows are scanned in tiles of at
    most DENSE_TILE_BYTES of f32 scores, each tile keeps its own top-r,
    and one exact top-r over the [B, tiles * r] winners merges them;
  * selection is exact `torch.topk` (the JAX package's approx_min_k is
    exact off the TPU too), so `recall_target` is accepted and ignored;
  * the product takes the bf16 operands the JAX side rounds to and sums
    in f32 (`preferred_element_type=f32` there): `torch.mm(...,
    out_dtype=float32)` on the card, an f32 product of the upcast
    operands on the CPU — bf16 products are exact in f32, so only the
    summation order differs;
  * the rerank's row fetch is the X1 kernel (ops/gather_rows.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from gamma_tpu_torch.ops.distances import BIG
from gamma_tpu_torch.ops import gather_rows as x1

# f32 scores held at once per scan tile: 1 GB is 262,144 rows at batch
# 1024 (four tiles over 1M rows) and bounds the transient whatever the
# batch
DENSE_TILE_BYTES = 1 << 30


def _approx_min_k(dist: torch.Tensor, k: int, recall_target: float = 0.95
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row, ascending → (vals, idx); padded with
    (BIG, -1) when the row holds fewer than k.  Exact: recall_target is
    the JAX package's approx_min_k knob and changes nothing here."""
    n = dist.shape[-1]
    vals, idx = torch.topk(dist, min(k, n), dim=-1, largest=False,
                           sorted=True)
    if k > n:
        vals = torch.nn.functional.pad(vals, (0, k - n), value=BIG)
        idx = torch.nn.functional.pad(idx, (0, k - n), value=-1)
    return vals, idx


def _scores(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """q [B, d] · rows [T, d]ᵀ → [B, T] f32, both operands in the
    mirror's dtype (bf16 products are exact in f32)."""
    if rows.dtype == torch.float32:
        return q @ rows.T
    if rows.is_cuda:
        return torch.mm(q, rows.T, out_dtype=torch.float32)
    return q.float() @ rows.float().T


def _tile_rows(b: int, r: int) -> int:
    return max(r, DENSE_TILE_BYTES // (4 * max(b, 1)))


def _tiled_min_k(score: Callable[[int, int], torch.Tensor], n: int, b: int,
                 r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-r smallest over n rows scored tile by tile: `score(s, e)`
    gives the [B, e - s] scores of rows [s, e).  Each tile keeps its own
    top-r; the merge is one exact top-r over the winners, so the result
    is the untiled select's up to the order of equal values."""
    tile = _tile_rows(b, r)
    if n <= tile:
        return _approx_min_k(score(0, n), r)
    vals, ids = [], []
    for s in range(0, n, tile):
        v, i = _approx_min_k(score(s, min(n, s + tile)), r)
        vals.append(v)
        ids.append(torch.where(i >= 0, i + s, -1))
    v, pos = torch.topk(torch.cat(vals, 1), r, dim=1, largest=False,
                        sorted=True)
    return v, torch.gather(torch.cat(ids, 1), 1, pos)


def _exact_rerank(queries_raw, raw, rd, rvid, dist_range, k: int,
                  metric: str):
    """Exact distances of the candidates against the store mirror's rows
    (fetched by X1), the optional score-range mask, and the top-k."""
    b, r = rvid.shape
    qr = queries_raw.float()
    rows = x1.gather_rows(raw, rvid.reshape(-1)).reshape(b, r, -1).float()
    if metric == "ip":
        exact = -(qr[:, None, :] * rows).sum(-1)
    else:
        diff = qr[:, None, :] - rows
        exact = (diff * diff).sum(-1)
    exact = torch.where((rd >= BIG) | (rvid < 0), BIG, exact)
    if dist_range is not None:
        exact = torch.where((exact < dist_range[0])
                            | (exact > dist_range[1]), BIG, exact)
    ed, sel = torch.topk(exact, k, dim=1, largest=False, sorted=True)
    evid = torch.gather(rvid, 1, sel)
    return ed, torch.where(ed >= BIG, -1, evid)


def _head(rd, rvid, k: int):
    return rd[:, :k], torch.where(rd[:, :k] >= BIG, -1, rvid[:, :k])


def dense_scan_search_fast(recon: torch.Tensor,        # [N_cap, d] bf16
                           bias: torch.Tensor,         # [N_cap] f32
                           queries: torch.Tensor,      # [B, d] pre-rotated
                           queries_raw: torch.Tensor,  # [B, d] unrotated
                           raw: torch.Tensor,          # [V_cap, d] rerank
                           live_n: int,                # live watermark
                           *, recall_num: int, k: int, metric: str = "l2",
                           rerank: bool = True,
                           recall_target: float = 0.95):
    """Unfiltered dense scan → (dists [B, k] f32, vids [B, k]).

    `bias` folds norms and slot validity into one operand (l2:
    recon_norms + recon_valid, ip: recon_valid; dead rows ~ +BIG), so the
    selection score is s = (-2q)·recon + bias (l2) or (-q)·recon + bias
    (ip); the per-query ||q||² is added after the select.  The live
    watermark masks candidates with vid >= live_n after the select, as
    the JAX function does."""
    scale = -1.0 if metric == "ip" else -2.0
    q2 = (scale * queries).to(recon.dtype)
    r = max(recall_num, k)

    def score(s, e):
        return _scores(q2, recon[s:e]).add_(bias[s:e])

    rd, rvid = _tiled_min_k(score, recon.shape[0], q2.shape[0], r)
    if metric != "ip":
        qf = queries.float()
        rd = rd + (qf * qf).sum(-1, keepdim=True)
    rd = torch.where(rvid >= live_n, BIG, rd)
    if not rerank:
        return _head(rd, rvid, k)
    return _exact_rerank(queries_raw, raw, rd, rvid, None, k, metric)


def dense_scan_search(recon: torch.Tensor,        # [N_cap, d] bf16
                      recon_norms: torch.Tensor,  # [N_cap] f32
                      queries: torch.Tensor,      # [B, d] (pre-rotated)
                      penalty: torch.Tensor,      # [N_cap] f32, vid-aligned
                      raw: torch.Tensor,          # [V_cap, d] rerank source
                      queries_raw: torch.Tensor,  # [B, d] unrotated
                      dist_range: Optional[torch.Tensor] = None,  # [2] f32
                      *, recall_num: int, k: int, metric: str = "l2",
                      rerank: bool = True, recall_target: float = 0.95):
    """→ (dists [B, k] f32, vids [B, k]).  vid-order scan: `penalty`
    carries deletes, filters and rows not yet published as +BIG.  With
    OPQ, `queries` is rotated into `recon`'s space while `queries_raw`
    and `raw` stay unrotated (the rotation is orthogonal).

    dist_range fuses the score-range filter into the select (on the
    penalty-free distance) and into the exact rerank (reference:
    IsSimilarScoreValid in the scanner, gamma_index_ivfpq.h:574-601)."""
    qf = queries.float()
    r = max(recall_num, k)
    n = recon.shape[0]
    if dist_range is None:
        scale = -1.0 if metric == "ip" else -2.0
        q2 = (scale * qf).to(recon.dtype)
        if metric == "ip":
            bias = torch.clamp_max(penalty, BIG)
        else:
            bias = torch.clamp_max(recon_norms + penalty, BIG)

        def score(s, e):
            return _scores(q2, recon[s:e]).add_(bias[s:e])

        rd, rvid = _tiled_min_k(score, n, q2.shape[0], r)
        if metric != "ip":
            rd = rd + (qf * qf).sum(-1, keepdim=True)
    else:
        qb = queries.to(recon.dtype)
        qn = (qf * qf).sum(-1, keepdim=True)
        lo, hi = dist_range[0], dist_range[1]

        def score(s, e):
            cross = _scores(qb, recon[s:e])
            if metric == "ip":
                raw_dist = cross.neg_()
            else:
                raw_dist = qn - 2.0 * cross + recon_norms[None, s:e]
            dist = raw_dist + penalty[None, s:e]
            out = (raw_dist < lo) | (raw_dist > hi)
            return torch.clamp_max(dist.masked_fill_(out, BIG), BIG)

        rd, rvid = _tiled_min_k(score, n, qb.shape[0], r)
    if not rerank:
        return _head(rd, rvid, k)
    return _exact_rerank(queries_raw, raw, rd, rvid, dist_range, k, metric)
