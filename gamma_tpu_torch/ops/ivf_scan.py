"""IVF search over the gather tier's payloads (counterpart of the IVFPQ,
FastScan, SQ8 and IVFFlat searches of gamma_tpu/ops/ivf_scan.py).

Pipeline per batch: coarse assign (one GEMM + top-nprobe) → per-(list,
slot) mask bias → scan → candidate select (exact top-k up to 2^14
candidates, the strided chunk-min prefilter beyond) → late id lookup →
optional exact rerank (candidate rows fetched by X1,
ops/gather_rows.py).  The scan is the grouped SQ8 scan over the
residual-SQ8 sidecar (ops/gsq.py, kernels B1/B2), or the ADC scan over
the PQ codes: grouped (ops/gadc.py, kernel B3) when M*ksub is a multiple
of 128 and for packed FastScan codes, per (query, probe) (ops/adc.py,
kernel B4) otherwise — the JAX package's TPU dispatch.  The IVFFlat
search (`ivfflat_search`) scans raw bf16 payload rows: grouped, through
the same B1 kernel in its bf16-row form, or per query over gathered
lists (the exact path without a kernel).
Smaller-is-better everywhere; IP scores are negated.

Indices are never out of range here: gathers clamp and then mask, since
an out-of-range index on a CUDA tensor is a device-side assert.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gamma_tpu_torch.ops import adc as adc_ops
from gamma_tpu_torch.ops import pq as pq_ops
from gamma_tpu_torch.ops.distances import (BIG, l2_norms, pairwise_ip,
                                           pairwise_l2)
from gamma_tpu_torch.ops.gadc import grouped_adc
from gamma_tpu_torch.ops import gather_rows as x1
from gamma_tpu_torch.ops.gsq import fold_geometry, grouped_sq_scan
from gamma_tpu_torch.ops.topk import topk_min
from gamma_tpu_torch.realtime.invert_index import IVFState

# widest [B, P*cap] candidate axis the exact select full-sorts; wider
# goes through the chunk-min prefilter + exact resort (_chunkmin_topk)
EXACT_SORT_MAX_WIDTH = 1 << 14
# chunk-min prefilter target width (chunk winners per query)
CHUNK_SELECT_TARGET = 24576


def coarse_assign(queries: torch.Tensor, centroids: torch.Tensor,
                  cent_norms: torch.Tensor, nprobe: int, metric: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (coarse_dists [B, P], list_ids [B, P] int64)."""
    if metric == "ip":
        d = -pairwise_ip(queries, centroids)
    else:
        d = pairwise_l2(queries, centroids, cent_norms)
    ids = torch.arange(centroids.shape[0],
                       device=d.device).expand(d.shape[0], -1)
    return topk_min(d, ids, nprobe)


def _take_fill(values: torch.Tensor, idx: torch.Tensor,
               fill: float) -> torch.Tensor:
    """values[idx] with `fill` wherever idx is outside [0, len)."""
    ok = (idx >= 0) & (idx < values.shape[0])
    got = values[idx.long().clamp(0, max(values.shape[0] - 1, 0))]
    return torch.where(ok, got, fill)


def _gather_lists(state: IVFState, list_ids: torch.Tensor):
    """Whole padded lists for each (query, probe)."""
    li = list_ids.long()
    return (state.codes[li],          # [B, P, cap, W] u8
            state.vids[li],           # [B, P, cap]
            state.docids[li],         # [B, P, cap]
            state.lens[li])           # [B, P]


def _candidate_mask_penalty(docids_g, lens_g, cap, penalty):
    """Per-candidate mask [B, P, cap]: the doc-space penalty of live
    slots, BIG for slots past the list length and tombstones (docid -1
    must be masked explicitly: it is no index)."""
    pos = torch.arange(cap, device=docids_g.device)
    ok = (pos[None, None, :] < lens_g[..., None]) & (docids_g >= 0)
    return torch.where(ok, _take_fill(penalty, docids_g, BIG), BIG)


def list_bias(docids, lens, cap, penalty=None, live_n=None):
    """Per-(list, slot) additive bias [nlist, cap] f32 folding the
    in-length, tombstone, and validity (or doc-space penalty) masks —
    computed once per call over nlist*cap slots, it rides the scan's
    norms operand instead of a per-(query, probe, slot) mask."""
    pos = torch.arange(cap, device=docids.device)[None, :]
    ok = (pos < lens[:, None]) & (docids >= 0)
    if live_n is not None:
        ok = ok & (docids < live_n)
        return torch.where(ok, 0.0, BIG).float()
    return torch.where(ok, _take_fill(penalty, docids, BIG), BIG)


def _chunkmin_topk(flat: torch.Tensor, rn: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Near-exact wide top-k: a g-wide chunk-min prefilter + an EXACT
    top-rn over the ~CHUNK_SELECT_TARGET chunk winners.

    The bins are STRIDED: bin c holds flat elements {c, c+L, c+2L, ...}.
    Two slots of one probed list sit < cap <= L apart, so same-list
    near-ties never share a bin (the contiguous variant lost recall at
    the 10M geometry).  Within-bin winners are recovered after the
    selection, over the rn chosen bins only."""
    b, width = flat.shape
    g = 4
    while width // g > CHUNK_SELECT_TARGET and g < 64:
        g *= 2
    wpad = -(-width // g) * g
    if wpad != width:
        flat = torch.nn.functional.pad(flat, (0, wpad - width), value=BIG)
    ell = wpad // g
    ch = flat.reshape(b, g, ell)
    cmin = ch.amin(dim=1)                               # [B, L]
    k_eff = min(rn, ell)
    vals, pos = torch.topk(cmin, k_eff, dim=1, largest=False, sorted=True)
    sel = torch.gather(ch, 2, pos[:, None, :].expand(b, g, k_eff))
    j = torch.argmin(sel, dim=1)                        # [B, rn]
    return vals, j * ell + pos


def _select_late(dist, list_ids, docids, vids, cap, recall_num,
                 exact: bool = False):
    """Candidate select with LATE id materialization: top-k runs on the
    distances alone, and doc/vid ids are looked up for the selected
    positions only.  Exact up to EXACT_SORT_MAX_WIDTH candidates per
    query, the strided chunk-min prefilter beyond.  `exact` changes
    nothing (the JAX package keeps it to document its call sites)."""
    b, p = list_ids.shape
    flat = dist.reshape(b, -1)
    if flat.shape[1] > EXACT_SORT_MAX_WIDTH:
        rd, ridx = _chunkmin_topk(flat, recall_num)
    else:
        rd, ridx = torch.topk(flat, min(recall_num, flat.shape[1]), dim=1,
                              largest=False, sorted=True)
    # ridx indexes the [P*cap] flatten: probe-major, slot-minor
    lst = torch.gather(list_ids, 1, ridx // cap)
    slot = ridx % cap
    rdoc, rvid = docids[lst, slot], vids[lst, slot]
    if rd.shape[1] < recall_num:
        padw = recall_num - rd.shape[1]
        rd = torch.nn.functional.pad(rd, (0, padw), value=BIG)
        rdoc = torch.nn.functional.pad(rdoc, (0, padw), value=-1)
        rvid = torch.nn.functional.pad(rvid, (0, padw), value=-1)
    dead = rd >= BIG
    return rd, rdoc.masked_fill(dead, -1), rvid.masked_fill(dead, -1)


def _select_candidates(dist, docids_g, vids_g, recall_num,
                       exact: bool = False):
    """Top-recall_num of gathered candidates [B, P, cap] with their ids:
    exact up to 2^14 candidates a query (or when `exact`), the strided
    chunk-min prefilter beyond, over the probe-major flatten."""
    b = dist.shape[0]
    flat = dist.reshape(b, -1)
    width = flat.shape[1]
    if width > EXACT_SORT_MAX_WIDTH and not exact:
        rd, ridx = _chunkmin_topk(flat, recall_num)
        if rd.shape[1] < recall_num:
            padw = recall_num - rd.shape[1]
            rd = torch.nn.functional.pad(rd, (0, padw), value=BIG)
            ridx = torch.nn.functional.pad(ridx, (0, padw))
    else:
        ids = torch.arange(width, device=flat.device).expand(b, -1)
        rd, ridx = topk_min(flat, ids, recall_num)
    # re-poison: masked candidates keep BIG dist and -1 ids (so do the
    # pad entries of topk_min, whose index is -1)
    dead = (rd >= BIG) | (ridx < 0)
    ridx = ridx.clamp_min(0)
    rdoc = torch.gather(docids_g.reshape(b, -1), 1, ridx)
    rvid = torch.gather(vids_g.reshape(b, -1), 1, ridx)
    return rd, rdoc.masked_fill(dead, -1), rvid.masked_fill(dead, -1)


def rerank_rows(queries, rd, rdoc, rvid, rows, dist_range=None, *, k: int,
                metric: str = "l2"):
    """Exact rerank against gathered candidate rows [B, R, d]
    (reference: compute_dis, gamma_index_ivfpq.cc:642-697)."""
    rows = rows.float()
    qf = queries.float()[:, None, :]
    if metric == "ip":
        exact = -(qf * rows).sum(-1)
    else:
        diff = qf - rows
        exact = (diff * diff).sum(-1)
    exact = torch.where(rd >= BIG, BIG, exact)
    if dist_range is not None:
        exact = torch.where((exact < dist_range[0])
                            | (exact > dist_range[1]), BIG, exact)
    ids = torch.arange(rd.shape[1], device=rd.device).expand_as(exact)
    ed, eidx = topk_min(exact, ids, k)
    dead = ed >= BIG
    return (ed, torch.gather(rdoc, 1, eidx).masked_fill(dead, -1),
            torch.gather(rvid, 1, eidx).masked_fill(dead, -1))


def _rerank(queries, rd, rdoc, rvid, raw_vectors, k, metric,
            dist_range=None):
    """Exact rerank of the candidates with rows of the store mirror,
    fetched by X1 (ops/gather_rows.py; a -1 candidate reads zeros)."""
    b, r = rvid.shape
    rows = x1.gather_rows(raw_vectors, rvid.reshape(-1)).reshape(b, r, -1)
    return rerank_rows(queries, rd, rdoc, rvid, rows, dist_range, k=k,
                       metric=metric)


def topk_like(rd, rdoc, rvid, k):
    if k == rd.shape[1]:
        return rd, rdoc, rvid
    return rd[:, :k], rdoc[:, :k], rvid[:, :k]


def _trim_state(state: IVFState, cap_eff: int) -> IVFState:
    """The posting state cut to the live-watermark ladder width (views).
    Exact: lens never exceed the caller's watermark, so slots past it
    are dead padding."""
    if not cap_eff or cap_eff >= state.cap:
        return state
    return state._replace(codes=state.codes[:, :cap_eff],
                          vids=state.vids[:, :cap_eff],
                          docids=state.docids[:, :cap_eff])


def _mask_range_select(raw_dist, bias_l, list_ids, state, dist_range, k,
                       recall_num, rerank, queries, queries_raw,
                       raw_vectors, metric):
    """The tail the ADC searches share: the mask (already fused into
    raw_dist when there is no score range), the fused score range, the
    recall heap and the optional exact rerank."""
    if dist_range is None:
        dist = raw_dist
    else:
        dist = raw_dist + bias_l[list_ids]
        # fused score range (reference: IsSimilarScoreValid inside the
        # scanner, gamma_index_ivfpq.h:574-601)
        dist = torch.where((raw_dist < dist_range[0])
                           | (raw_dist > dist_range[1]), BIG, dist)
    dist = torch.clamp_max(dist, BIG)
    rd, rdoc, rvid = _select_late(dist, list_ids, state.docids, state.vids,
                                  state.cap, recall_num, exact=True)
    if not rerank:
        return topk_like(rd, rdoc, rvid, k)
    # rerank compares against the raw rows, so it takes the raw queries
    qr = queries if queries_raw is None else queries_raw
    return _rerank(qr, rd, rdoc, rvid, raw_vectors, k, metric, dist_range)


def ivfpq_search(state: IVFState,
                 centroids: torch.Tensor,     # [nlist, d] f32
                 cent_norms: torch.Tensor,    # [nlist] f32
                 codebooks: pq_ops.PQCodebooks,
                 queries: torch.Tensor,       # [B, d]
                 penalty: torch.Tensor,       # [N_cap] f32
                 raw_vectors: torch.Tensor,   # [V_cap, d]
                 queries_raw: Optional[torch.Tensor] = None,
                 dist_range: Optional[torch.Tensor] = None,  # [2] f32
                 live_n: Optional[int] = None,
                 *, nprobe: int, recall_num: int, k: int,
                 metric: str = "l2", rerank: bool = True,
                 cap_eff: int = 0):
    """ADC search over the PQ payload → (dists [B, k] f32, docids [B, k],
    vids [B, k]); masked or empty slots return dist >= BIG and id -1.

    The scan is the grouped ADC kernel (B3) when M*ksub is a multiple of
    128, else the per-(query, probe) kernel (B4) over LUTs built here —
    the JAX package's TPU dispatch.  cap_eff trims the scan to the live
    list-length watermark ladder."""
    state = _trim_state(state, cap_eff)
    cd, list_ids = coarse_assign(queries, centroids, cent_norms, nprobe,
                                 metric)
    bias_l = list_bias(state.docids, state.lens, state.cap,
                       penalty=penalty, live_n=live_n)   # [nlist, cap]
    # with a score range the mask stays out of the scanned value (the
    # range tests the raw distance); otherwise it rides the scan
    fuse_bias = dist_range is None
    if (codebooks.M * codebooks.ksub) % 128 == 0:
        adc = grouped_adc(state.codes, state.lens, list_ids, queries,
                          centroids, codebooks, metric=metric,
                          bias=bias_l if fuse_bias else None)
        raw_dist = adc + cd[..., None]
    else:
        if metric == "ip":
            # score = q.c + q.decode(residual code); dist = -score
            lut = -pq_ops.ip_lut(codebooks, queries)        # [B, M, ksub]
            lut = lut[:, None].expand(-1, nprobe, -1, -1)
            base = cd[..., None]                            # -q.c
        else:
            residual = queries.float()[:, None, :] - centroids[list_ids]
            lut = pq_ops.l2_lut(codebooks, residual)        # [B, P, M, ksub]
            base = 0.0
        raw_dist = adc_ops.adc(state.codes, list_ids, lut) + base
        if fuse_bias:
            raw_dist = raw_dist + bias_l[list_ids]
    return _mask_range_select(raw_dist, bias_l, list_ids, state, dist_range,
                              k, recall_num, rerank, queries, queries_raw,
                              raw_vectors, metric)


def ivfpqfs_search(state: IVFState,           # codes packed [nlist, cap, M/2]
                   centroids: torch.Tensor,
                   cent_norms: torch.Tensor,
                   codebooks: pq_ops.PQCodebooks,   # ksub = 16
                   queries: torch.Tensor,
                   penalty: torch.Tensor,
                   raw_vectors: torch.Tensor,
                   queries_raw: Optional[torch.Tensor] = None,
                   dist_range: Optional[torch.Tensor] = None,
                   live_n: Optional[int] = None,
                   *, nprobe: int, recall_num: int, k: int,
                   metric: str = "l2", rerank: bool = True,
                   by_residual: bool = True, cap_eff: int = 0):
    """FastScan search over packed 4-bit codes through the grouped ADC
    kernel (B3, packed form).  by_residual=False is the reference's
    layout (4-bit PQ of the raw vector, gamma_index_ivfpqfs.cc:146): the
    LUT then comes from the query itself and the L2 distance adds
    ||q||^2 instead of the coarse term.  Same mask, score range, recall
    heap and rerank contract as ivfpq_search."""
    state = _trim_state(state, cap_eff)
    cd, list_ids = coarse_assign(queries, centroids, cent_norms, nprobe,
                                 metric)
    bias_l = list_bias(state.docids, state.lens, state.cap,
                       penalty=penalty, live_n=live_n)
    adc = grouped_adc(state.codes, state.lens, list_ids, queries,
                      centroids, codebooks, metric=metric, packed=True,
                      residual=by_residual,
                      bias=bias_l if dist_range is None else None)
    if by_residual:
        raw_dist = adc + cd[..., None]
    elif metric == "ip":
        raw_dist = adc
    else:
        raw_dist = adc + l2_norms(queries)[:, None, None]
    return _mask_range_select(raw_dist, bias_l, list_ids, state, dist_range,
                              k, recall_num, rerank, queries, queries_raw,
                              raw_vectors, metric)


def sq_raw_dist_plain(sq_codes, sq_norms, sq_scale, sq_off, centroids,
                      list_ids, queries, *, metric: str = "l2"):
    """Plain oracle of the grouped scan (the counterpart of
    sq_raw_dist_xla): gather + dequantize + f32 einsum, materializing
    [B, P, cap, d] — for tests at small shapes only."""
    qf = queries.float()
    d = qf.shape[1]
    cg = sq_codes[list_ids.long()][..., :d].float()
    x = (sq_off + sq_scale * cg
         + centroids[list_ids.long()][:, :, None, :].float())
    qx = torch.einsum("bd,bpcd->bpc", qf, x)
    if metric == "ip":
        return -qx
    return ((qf * qf).sum(-1)[:, None, None] - 2.0 * qx
            + sq_norms[list_ids.long()])


def ivfsq_search(state: IVFState,
                 sq_codes: torch.Tensor,      # [nlist, sq_cap, d_pad] u8
                 sq_norms: torch.Tensor,      # [nlist, sq_cap] f32
                 sq_scale: torch.Tensor,      # [d] f32
                 sq_off: torch.Tensor,        # [d] f32
                 centroids: torch.Tensor,     # [nlist, d] f32
                 cent_norms: torch.Tensor,    # [nlist] f32
                 queries: torch.Tensor,       # [B, d]
                 penalty: torch.Tensor,       # [N_cap] f32
                 dist_range: Optional[torch.Tensor] = None,  # [2] f32
                 live_n: Optional[int] = None,
                 raw_vectors: Optional[torch.Tensor] = None,  # [V, d]
                 queries_raw: Optional[torch.Tensor] = None,
                 *, nprobe: int, k: int, metric: str = "l2",
                 cap_eff: int = 0, recall_num: int = 0,
                 rerank: bool = False):
    """Residual-SQ8 capacity search: scan distances are exact distances
    to the dequantized points, so the top-k is selected straight from
    the scan (no recall heap, no rerank gather) unless `rerank` asks for
    an exact rerank of the top max(recall_num, 8k) against raw_vectors.

    The scan width is the live watermark ladder `cap_eff`, never wider
    than the posting cap or the sidecar (slots past max(lens) are dead,
    so trimming is exact).  At width >= 4096 with no score range the
    folded kernel (B2) runs; otherwise B1.
    → (dists [B, k] f32, docids [B, k], vids [B, k])."""
    cap = state.cap
    sq_cap = sq_codes.shape[1]
    eff = min(cap, sq_cap, cap_eff or sq_cap)
    sq_codes, sq_norms = sq_codes[:, :eff], sq_norms[:, :eff]
    docids, vids = state.docids[:, :eff], state.vids[:, :eff]
    cap = eff
    _, list_ids = coarse_assign(queries, centroids, cent_norms, nprobe,
                                metric)
    bias_l = list_bias(docids, state.lens, cap, penalty=penalty,
                       live_n=live_n)                    # [nlist, cap]
    fuse_bias = dist_range is None
    b = queries.shape[0]

    if fuse_bias and cap >= 4096:
        fold = 8
        tile, lb = fold_geometry(cap, 4096, fold)
        dist_f, args_f = grouped_sq_scan(
            sq_codes, sq_norms, state.lens, list_ids, queries, sq_scale,
            sq_off, centroids=centroids, metric=metric, bias=bias_l,
            fold=fold, tile=tile)
        capf = cap // fold
        flat = torch.clamp_max(dist_f, BIG).reshape(b, -1)
        rn = max(recall_num, k) if rerank else k
        if flat.shape[1] > EXACT_SORT_MAX_WIDTH:
            rd, ridx = _chunkmin_topk(flat, rn)
        else:
            rd, ridx = torch.topk(flat, min(rn, flat.shape[1]), dim=1,
                                  largest=False, sorted=True)
        fidx = ridx % capf
        arg_sel = torch.gather(args_f.reshape(b, -1), 1, ridx).long()
        slot = (fidx // lb) * tile + arg_sel * lb + fidx % lb
        lst = torch.gather(list_ids, 1, ridx // capf)
        dead = rd >= BIG
        rdoc = docids[lst, slot].masked_fill(dead, -1)
        rvid = vids[lst, slot].masked_fill(dead, -1)
        if not rerank:
            return topk_like(rd, rdoc, rvid, k)
        qr = queries if queries_raw is None else queries_raw
        return _rerank(qr, rd, rdoc, rvid, raw_vectors, k, metric,
                       dist_range)

    raw_dist = grouped_sq_scan(sq_codes, sq_norms, state.lens, list_ids,
                               queries, sq_scale, sq_off,
                               centroids=centroids, metric=metric,
                               bias=bias_l if fuse_bias else None)
    if fuse_bias:
        dist = raw_dist
    else:
        dist = raw_dist + bias_l[list_ids]
        # fused score range (reference: IsSimilarScoreValid inside the
        # scanner, gamma_index_ivfpq.h:574-601)
        dist = torch.where((raw_dist < dist_range[0])
                           | (raw_dist > dist_range[1]), BIG, dist)
    dist = torch.clamp_max(dist, BIG)
    if not rerank:
        return _select_late(dist, list_ids, docids, vids, cap, k)
    rn = max(recall_num or 8 * k, k)
    rd, rdoc, rvid = _select_late(dist, list_ids, docids, vids, cap, rn)
    qr = queries if queries_raw is None else queries_raw
    return _rerank(qr, rd, rdoc, rvid, raw_vectors, k, metric, dist_range)


# ---------------------------------------------------------------------
# IVFFlat: codes are bf16 raw vectors stored as bytes in the same state
# (reference: gamma_index_ivfflat.{h,cc} — full vectors as "codes")
# ---------------------------------------------------------------------

# Transient budget of the per-query exact scan: the [Bc, P, cap, W] u8
# gather and its f32 expansion are materialized before the distance
# reduction, so queries go through in chunks sized to this
FLAT_GATHER_BYTES = 1 << 30
# lists per chunk of the grouped scan's row-norm reduction (bounds the
# f32 copy of the rows it squares)
_NORM_LISTS = 128


def _batched_exact_scan(queries, chunk_fn, per_query_bytes):
    """Run chunk_fn over query chunks sized to FLAT_GATHER_BYTES, one
    after another, so only one chunk's gather transient is live.
    chunk_fn: [Bc, d] -> (rd [Bc, k], rdoc, rvid)."""
    b = queries.shape[0]
    bc = max(1, min(b, FLAT_GATHER_BYTES // max(per_query_bytes, 1)))
    if bc >= b:
        return chunk_fn(queries)
    outs = [chunk_fn(queries[s:s + bc]) for s in range(0, b, bc)]
    return tuple(torch.cat(t) for t in zip(*outs))


def payload_rows(codes: torch.Tensor, d: int) -> torch.Tensor:
    """The u8 payload [..., 2d] of an IVFFlat state as bf16 rows [..., d]
    (a view: nothing is copied)."""
    return codes.view(torch.bfloat16)[..., :d]


def _row_norms(rows: torch.Tensor) -> torch.Tensor:
    """||row||^2 of bf16 rows [nlist, cap, d] in f32, reduced in chunks
    of lists (the f32 copy of all rows at once is 2x the payload)."""
    out = torch.empty(rows.shape[:2], dtype=torch.float32,
                      device=rows.device)
    for s in range(0, rows.shape[0], _NORM_LISTS):
        r = rows[s:s + _NORM_LISTS].float()
        out[s:s + _NORM_LISTS] = (r * r).sum(-1)
    return out


def ivfflat_search(state: IVFState, centroids, cent_norms, queries,
                   penalty, dist_range=None, *, nprobe: int, k: int,
                   d: int, metric: str = "l2", scan_impl: str = "grouped",
                   cap_eff: int = 0):
    """Exact-distance IVF scan: posting payload = bf16 vector bytes.

    scan_impl="grouped" (the JAX package's TPU dispatch, "pallas" there)
    goes through the grouped row kernel (ops/gsq.py, B1 over raw bf16
    rows): queries probing the same list share its rows, so each probed
    list's payload is read once per batch.  scan_impl="gather" (the JAX
    package's "xla") gathers every probed list per query and reduces
    the distances in plain torch.  Both are exact to the stored bf16
    rows (the grouped form rounds the query to bf16 for its product).
    → (dists [B, k] f32, docids [B, k], vids [B, k])."""
    if scan_impl == "grouped":
        return _ivfflat_grouped(state, centroids, cent_norms, queries,
                                penalty, dist_range, nprobe=nprobe, k=k,
                                d=d, metric=metric, cap_eff=cap_eff)
    if scan_impl != "gather":
        raise ValueError(f"scan_impl {scan_impl!r}: 'grouped' or 'gather'")
    state = _trim_state(state, cap_eff)
    cap, w = state.codes.shape[1], state.codes.shape[2]

    def _chunk(qc):
        _, list_ids = coarse_assign(qc, centroids, cent_norms, nprobe,
                                    metric)
        codes_g, vids_g, docids_g, lens_g = _gather_lists(state, list_ids)
        vecs = payload_rows(codes_g.contiguous(), d).float()  # [Bc,P,cap,d]
        qf = qc.float()
        if metric == "ip":
            raw_dist = -torch.einsum("bd,bpcd->bpc", qf, vecs)
        else:
            diff = qf[:, None, None, :] - vecs
            raw_dist = (diff * diff).sum(-1)
        dist = raw_dist + _candidate_mask_penalty(docids_g, lens_g, cap,
                                                  penalty)
        if dist_range is not None:
            dist = torch.where((raw_dist < dist_range[0])
                               | (raw_dist > dist_range[1]), BIG, dist)
        dist = torch.clamp_max(dist, BIG)
        return _select_candidates(dist, docids_g, vids_g, k)

    # gather transient per query: the payload bytes + their f32 expansion
    per_q = nprobe * cap * (w + 4 * d)
    return _batched_exact_scan(queries, _chunk, per_q)


def _ivfflat_grouped(state: IVFState, centroids, cent_norms, queries,
                     penalty, dist_range, *, nprobe: int, k: int, d: int,
                     metric: str, cap_eff: int):
    """Grouped IVFFlat scan: view the byte payload as bf16 rows and run
    the B1 kernel with scale/off None.  The row norms are reduced from
    the same bf16 rows on every call, so L2 distances are exact to the
    stored payload.  The rows are padded only when d is no multiple of
    16 (the kernel's 16-dim k-steps)."""
    state = _trim_state(state, cap_eff)
    cap = state.codes.shape[1]
    rows = payload_rows(state.codes, d)
    if d % 16:
        rows = torch.nn.functional.pad(rows, (0, 16 - d % 16))
    if metric != "ip":
        norms = _row_norms(rows)
    else:
        norms = torch.zeros(rows.shape[:2], dtype=torch.float32,
                            device=rows.device)
    _, list_ids = coarse_assign(queries, centroids, cent_norms, nprobe,
                                metric)
    bias_l = list_bias(state.docids, state.lens, cap, penalty=penalty)
    fuse_bias = dist_range is None
    raw_dist = grouped_sq_scan(rows, norms, state.lens, list_ids, queries,
                               None, None, metric=metric,
                               bias=bias_l if fuse_bias else None)
    if fuse_bias:
        dist = raw_dist
    else:
        dist = raw_dist + bias_l[list_ids]
        dist = torch.where((raw_dist < dist_range[0])
                           | (raw_dist > dist_range[1]), BIG, dist)
    dist = torch.clamp_max(dist, BIG)
    return _select_late(dist, list_ids, state.docids, state.vids, cap, k,
                        exact=True)
