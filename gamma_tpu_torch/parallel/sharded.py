"""Sharding of inverted lists over a mesh of devices (counterpart of
gamma_tpu/parallel/sharded.py).

The inverted lists, coarse centroids and raw rows are split over the
mesh's list axis ("l"); a query batch is split over its query axis
("q").  One controller drives every shard, as JAX's shard_map does: a
search is a sequence of per-shard steps split at its collectives,

  1. local coarse assign       — each shard scores the queries against
                                 its own centroids and keeps its
                                 top-nprobe;
  2. global probe threshold    — all_gather of those distances [B,
                                 S*nprobe]: the nprobe-th smallest is
                                 the threshold, and each shard scans
                                 only its lists that pass it (at most
                                 local_probe of them);
  3. local scan + select       — the single-device scan over the
                                 selected local lists (B3 over PQ codes,
                                 B1 over the SQ8 sidecar), then the
                                 select;
  4. merge                     — all_gather of (dist, docid, vid) and
                                 one top-k;
  5. owner-computes rerank     — the raw rows are row-sharded on the same
                                 axis: each candidate's owner computes
                                 its exact distance from rows X1 fetches,
                                 every other shard contributes 0, and a
                                 psum of the [B, R] distances reassembles
                                 the exact result.

The collectives are plain tensor moves: `all_gather(parts, dim)`
concatenates the shards' parts in shard order and places the result on
every shard's device; `psum(parts)` adds them in shard order.  Nothing
between the steps waits for the device (no .item(), .cpu() or
synchronize), so shards on distinct cards overlap.  A mesh may repeat a
device: `[cpu] * 8` stands in for eight devices on the CPU, `[cuda:0] *
8` for eight cards on one.

Exactness: step 2 scans every globally selected list as long as no
shard owns more than local_probe of them; the default local_probe =
min(nprobe, 2*ceil(nprobe/S)+2) makes overflow rare, and local_probe =
nprobe gives the single-device result.

The scans are the single-device wrappers (ops/gadc.grouped_adc,
ops/gsq.grouped_sq_scan, ops/gather_rows.gather_rows): they launch the
CUDA kernels for tensors on the card and run the plain versions for
tensors on the CPU, so the JAX functions' `scan_impl` has no
counterpart here.  The outputs land on the mesh's first device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gamma_tpu_torch.ops import pq as pq_ops
from gamma_tpu_torch.ops.dense_scan import _scores, _tiled_min_k
from gamma_tpu_torch.ops.distances import (BIG, l2_norms, pairwise_ip,
                                           pairwise_l2)
from gamma_tpu_torch.ops.gadc import grouped_adc
from gamma_tpu_torch.ops import gather_rows as x1
from gamma_tpu_torch.ops.gsq import grouped_sq_scan
from gamma_tpu_torch.ops.ivf_scan import _select_late, list_bias
from gamma_tpu_torch.ops.kmeans import _cluster_sums, assign_nearest
from gamma_tpu_torch.ops.topk import topk_min
from gamma_tpu_torch.realtime.invert_index import IVFState

LIST_AXIS = "l"    # inverted lists + raw-vector rows sharded over this
QUERY_AXIS = "q"   # query batch sharded over this


class Mesh:
    """A [n_q, n_l] grid of devices: `devices[q][l]` runs list shard l
    of query block q."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.devices = [list(row) for row in grid]
        self.shape = {QUERY_AXIS: len(self.devices),
                      LIST_AXIS: len(self.devices[0])}


def _device(d) -> torch.device:
    """`d` as a torch.device with its index (a tensor's .device has one)."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_mesh(n_list_shards: int, n_query_shards: int = 1,
               devices=None) -> Mesh:
    """The first n_q * n_l of `devices` (default: every CUDA device) as
    a grid, row-major.  A device may appear more than once."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    need = n_list_shards * n_query_shards
    if len(devices) < need:
        raise ValueError(f"mesh {n_query_shards}x{n_list_shards} needs "
                         f"{need} devices, have {len(devices)}")
    return Mesh([devices[q * n_list_shards:(q + 1) * n_list_shards]
                 for q in range(n_query_shards)])


class Sharded:
    """One array laid out on a mesh (a jax array with a NamedSharding):
    `parts[q][l]` lives on mesh.devices[q][l]; `shape` is the whole
    array's."""

    def __init__(self, parts: List[List[torch.Tensor]], shape):
        self.parts = parts
        self.shape = tuple(shape)

    def local(self, q: int, l: int) -> torch.Tensor:
        return self.parts[q][l]


def _place(mesh: Mesh, chunks: Sequence[torch.Tensor]) -> List[List]:
    """chunks[l] onto every device of column l, one copy a device."""
    memo = {}

    def put(i, dev):
        if (i, dev) not in memo:
            memo[(i, dev)] = chunks[i].to(dev)
        return memo[(i, dev)]

    return [[put(l, dev) for l, dev in enumerate(row)]
            for row in mesh.devices]


def _rows(mesh: Mesh, x: torch.Tensor) -> Sharded:
    """x [S*n, ...] split into S contiguous row blocks over "l" (each
    made dense), replicated over "q"."""
    s = mesh.shape[LIST_AXIS]
    n = x.shape[0] // s
    assert n * s == x.shape[0], (x.shape, s)
    return Sharded(_place(mesh, [x[i * n:(i + 1) * n].contiguous()
                                 for i in range(s)]), x.shape)


def _replicated(mesh: Mesh, x: torch.Tensor) -> Sharded:
    return Sharded(_place(mesh, [x] * mesh.shape[LIST_AXIS]), x.shape)


def _pad_axis0(x: torch.Tensor, size: int, fill=0) -> torch.Tensor:
    if x.shape[0] == size:
        return x
    pad = x.new_full((size - x.shape[0],) + tuple(x.shape[1:]), fill)
    return torch.cat([x, pad], dim=0)


def all_gather(parts: Sequence[torch.Tensor], dim: int
               ) -> List[torch.Tensor]:
    """The shards' parts concatenated along `dim` in shard order, one
    result on each shard's device."""
    done = {}
    for p in parts:
        if p.device not in done:
            done[p.device] = torch.cat([x.to(p.device) for x in parts], dim)
    return [done[p.device] for p in parts]


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the shards' parts, added in shard order, one result on
    each shard's device."""
    done = {}
    for p in parts:
        if p.device not in done:
            acc = parts[0].to(p.device)
            for x in parts[1:]:
                acc = acc + x.to(p.device)
            done[p.device] = acc
    return [done[p.device] for p in parts]


def _by_query_block(mesh: Mesh, row_fn, queries: torch.Tensor, *more):
    """Run row_fn(qi, [queries block on each shard of row qi], *[the
    same of each `more` batch tensor]) for every query block and
    concatenate its outputs along the batch on the mesh's first
    device."""
    n_q = mesh.shape[QUERY_AXIS]
    b = queries.shape[0]
    if b % n_q:
        raise ValueError(f"batch {b} does not divide over {n_q} query "
                         "shards")
    bq = b // n_q
    outs = []
    for qi, row in enumerate(mesh.devices):
        blocks = [[t[qi * bq:(qi + 1) * bq].to(dev) for dev in row]
                  for t in (queries,) + more]
        outs.append(row_fn(qi, *blocks))
    first = mesh.devices[0][0]
    return tuple(torch.cat([o[j].to(first) for o in outs], dim=0)
                 for j in range(len(outs[0])))


def _probe_select(queries, cents, cnorms, *, nprobe, local_probe, metric):
    """Steps 1-2 on the shards of one query block → per shard (sel_d,
    sel_ids, sel_ok) over its first local_probe local lists."""
    ld, lids = [], []
    for q, c, cn in zip(queries, cents, cnorms):
        l_loc = c.shape[0]
        dloc = (-pairwise_ip(q, c) if metric == "ip"
                else pairwise_l2(q, c, cn))
        ids = torch.arange(l_loc, device=dloc.device).expand(dloc.shape[0],
                                                              -1)
        d, i = topk_min(dloc, ids, min(nprobe, l_loc))   # ascending
        ld.append(d)
        lids.append(i)
    out = []
    for d, i, all_d in zip(ld, lids, all_gather(ld, 1)):
        n_glob = min(nprobe, all_d.shape[1])
        thr = torch.topk(all_d, n_glob, dim=1, largest=False,
                         sorted=True).values[:, n_glob - 1]
        p_loc = min(local_probe, d.shape[1])
        sel_d, sel_ids = d[:, :p_loc], i[:, :p_loc]
        out.append((sel_d, sel_ids, sel_d <= thr[:, None]))
    return out


def _mask_unselected(dist, sel_ok):
    return torch.clamp_max(dist + torch.where(sel_ok, 0.0, BIG)[..., None],
                           BIG)


def _merge(rd, ids: Sequence[Sequence[torch.Tensor]], k: int):
    """Step 4: all_gather of each shard's (dist, *ids) and one top-k →
    per shard (md, *merged ids)."""
    rd_g = all_gather(rd, 1)
    ids_g = [all_gather(part, 1) for part in ids]
    done = {}                 # shards on one device share one merge
    for s, d in enumerate(rd_g):
        if d.device not in done:
            pos = torch.arange(d.shape[1], device=d.device).expand_as(d)
            md, sel = topk_min(d, pos, k)
            done[d.device] = (md,) + tuple(torch.gather(g[s], 1, sel)
                                           for g in ids_g)
    return [done[d.device] for d in rd_g]


def _owner_exact(raw_l, queries_raw, gidx, my: int, per_shard: int,
                 metric: str, valid):
    """Step 5 on one shard: the exact distances of the candidates whose
    row it owns (clipped index, X1 fetch, then masked), 0 elsewhere."""
    b, r = gidx.shape
    local_idx = gidx - my * per_shard
    in_range = (local_idx >= 0) & (local_idx < per_shard) & valid
    idx = local_idx.clamp(0, per_shard - 1).reshape(-1)
    rows = x1.gather_rows(raw_l, idx).reshape(b, r, -1).float()
    qf = queries_raw.float()[:, None, :]
    if metric == "ip":
        exact = -(qf * rows).sum(-1)
    else:
        diff = qf - rows
        exact = (diff * diff).sum(-1)
    return torch.where(in_range, exact, 0.0)


# ----------------------------------------------------------------------
# IVFPQ: PQ codes sharded over "l", exact rerank against raw rows
# ----------------------------------------------------------------------

class ShardedIVFPQ(NamedTuple):
    """Device-sharded index: lists (axis 0) and raw rows over LIST_AXIS."""

    state: IVFState              # codes/vids/docids/lens sharded on axis 0
    centroids: Sharded           # [nlist_pad, d] sharded on axis 0
    cent_norms: Sharded          # [nlist_pad]
    codebooks: pq_ops.PQCodebooks   # replicated (Sharded fields)
    raw: Sharded                 # [V_pad, d] row-sharded on axis 0
    v_per_shard: int             # raw rows per shard


def _shard_lists(mesh: Mesh, centroids, l_pad: int):
    """Centroids padded to l_pad lists (padded rows 1e18, so they never
    win the coarse assign; norms summed in float64) and sharded."""
    nlist = centroids.shape[0]
    cents = _pad_axis0(centroids.float(), l_pad)
    if l_pad > nlist:
        cents = cents.clone()
        cents[nlist:] = 1e18
    cnorms = (cents.double() ** 2).sum(-1).float()
    return _rows(mesh, cents), _rows(mesh, cnorms)


def shard_ivfpq(mesh: Mesh, state: IVFState, centroids, cent_norms,
                codebooks: pq_ops.PQCodebooks, raw,
                cap_eff: int = 0) -> ShardedIVFPQ:
    """Distribute a single-device index over the mesh.  Lists and raw
    rows are padded to a multiple of the shard count and split
    contiguously: shard i owns lists [i*L_loc, (i+1)*L_loc) and rows
    [i*V_loc, (i+1)*V_loc).  docids/vids stay GLOBAL ids.  `cent_norms`
    is recomputed from the padded centroids.

    cap_eff (IVFPQIndex._cap_eff) trims the posting arrays to the live
    width once, here; each shard's slice is made dense."""
    s = mesh.shape[LIST_AXIS]
    nlist = state.nlist
    l_pad = -(-nlist // s) * s
    v = raw.shape[0]
    v_pad = -(-v // s) * s
    codes, vids, docids = state.codes, state.vids, state.docids
    if cap_eff and cap_eff < vids.shape[1]:
        codes, vids, docids = (codes[:, :cap_eff], vids[:, :cap_eff],
                               docids[:, :cap_eff])
    st = IVFState(codes=_rows(mesh, _pad_axis0(codes, l_pad)),
                  vids=_rows(mesh, _pad_axis0(vids, l_pad, -1)),
                  docids=_rows(mesh, _pad_axis0(docids, l_pad, -1)),
                  lens=_rows(mesh, _pad_axis0(state.lens, l_pad)))
    cents, cnorms = _shard_lists(mesh, centroids, l_pad)
    cb = pq_ops.PQCodebooks(_replicated(mesh, codebooks.codebooks),
                            _replicated(mesh, codebooks.cb_norms))
    return ShardedIVFPQ(state=st, centroids=cents, cent_norms=cnorms,
                        codebooks=cb, raw=_rows(mesh, _pad_axis0(raw, v_pad)),
                        v_per_shard=v_pad // s)


def _local_ivfpq_search(sh: ShardedIVFPQ, qi: int, queries, penalty,
                        queries_raw, live_n, *, nprobe, local_probe,
                        recall_num, k, metric, rerank, v_per_shard,
                        use_validity=False, packed=False, by_residual=True):
    """The shard bodies of one query block (lists over its shards) →
    (dists [b, k], docids [b, k], vids [b, k]) of its first shard."""
    s = len(queries)
    loc = [(sh.state.codes.local(qi, i), sh.state.vids.local(qi, i),
            sh.state.docids.local(qi, i), sh.state.lens.local(qi, i))
           for i in range(s)]
    cents = [sh.centroids.local(qi, i) for i in range(s)]
    sel = _probe_select(queries, cents,
                        [sh.cent_norms.local(qi, i) for i in range(s)],
                        nprobe=nprobe, local_probe=local_probe,
                        metric=metric)

    # 3. grouped ADC scan of the selected local lists; the per-(list,
    # slot) mask bias rides the scan and ids materialize after select
    rd, rdoc, rvid = [], [], []
    for i, ((codes, vids, docids, lens), (sel_d, sel_ids, sel_ok)) in \
            enumerate(zip(loc, sel)):
        cap = codes.shape[1]
        bias_l = list_bias(docids, lens, cap, penalty=penalty[i],
                           live_n=live_n if use_validity else None)
        cb = pq_ops.PQCodebooks(sh.codebooks.codebooks.local(qi, i),
                                sh.codebooks.cb_norms.local(qi, i))
        adc = grouped_adc(codes, lens, sel_ids, queries[i], cents[i], cb,
                          metric=metric, bias=bias_l, packed=packed,
                          residual=by_residual)
        if by_residual:
            dist = adc + sel_d[..., None]
        elif metric == "ip":
            dist = adc
        else:
            # raw-coded 4-bit: adc carries -2 q.dq + ||dq||²
            dist = adc + l2_norms(queries[i])[:, None, None]
        d, doc, vid = _select_late(_mask_unselected(dist, sel_ok), sel_ids,
                                   docids, vids, cap, recall_num)
        rd.append(d)
        rdoc.append(doc)
        rvid.append(vid)

    # 4. merge
    merged = _merge(rd, (rdoc, rvid), recall_num)
    if not rerank:
        md, mdoc, mvid = merged[0]
        return md[:, :k], mdoc[:, :k], mvid[:, :k]

    # 5. owner-computes rerank + distance psum, in the UNROTATED space
    # (raw rows are unrotated; with OPQ `queries` is rotated)
    exact = psum([_owner_exact(sh.raw.local(qi, i), queries_raw[i], mvid, i,
                               v_per_shard, metric, mvid >= 0)
                  for i, (_, _, mvid) in enumerate(merged)])
    md, mdoc, mvid = merged[0]
    ex = torch.where((md >= BIG) | (mvid < 0), BIG, exact[0])
    pos = torch.arange(md.shape[1], device=md.device).expand_as(ex)
    ed, eidx = topk_min(ex, pos, k)
    dead = ed >= BIG
    return (ed, torch.gather(mdoc, 1, eidx).masked_fill(dead, -1),
            torch.gather(mvid, 1, eidx).masked_fill(dead, -1))


def _local_probe(nprobe: int, s: int, local_probe: Optional[int]) -> int:
    if local_probe is None:
        return min(nprobe, 2 * (-(-nprobe // s)) + 2)
    return local_probe


def sharded_ivfpq_search_fn(mesh: Mesh, *, nprobe: int, recall_num: int,
                            k: int, metric: str = "l2",
                            rerank: bool = True,
                            local_probe: Optional[int] = None,
                            v_per_shard: int,
                            use_validity: bool = False,
                            packed: bool = False,
                            by_residual: bool = True):
    """The sharded search for a fixed geometry.

    Returned fn: (sharded: ShardedIVFPQ, queries [B, d], penalty [N_cap],
    queries_raw=None, live_n=0) → (dists [B, k], docids [B, k], vids
    [B, k]).  B must divide by the "q" axis size."""
    local_probe = _local_probe(nprobe, mesh.shape[LIST_AXIS], local_probe)

    def search(sharded: ShardedIVFPQ, queries, penalty, queries_raw=None,
               live_n=0):
        qr = queries if queries_raw is None else queries_raw

        def row(qi, q, q_raw):
            pen = [penalty.to(dev) for dev in mesh.devices[qi]]
            return _local_ivfpq_search(
                sharded, qi, q, pen, q_raw, int(live_n), nprobe=nprobe,
                local_probe=local_probe, recall_num=recall_num, k=k,
                metric=metric, rerank=rerank, v_per_shard=v_per_shard,
                use_validity=use_validity, packed=packed,
                by_residual=by_residual)

        return _by_query_block(mesh, row, queries, qr)

    return search


# ----------------------------------------------------------------------
# sharded residual-SQ8 capacity scan (no rerank: exact distances to the
# dequantized points come straight out of the list scan, so the merge
# is the LAST step)
# ----------------------------------------------------------------------

class ShardedIVFSQ(NamedTuple):
    """Capacity-tier serving snapshot: posting ids + SQ8 sidecar sharded
    over LIST_AXIS; the dequant affine (scale/off) is replicated."""

    vids: Sharded              # [nlist_pad, cap] i32, sharded axis 0
    docids: Sharded            # [nlist_pad, cap] i32, sharded axis 0
    lens: Sharded              # [nlist_pad] i32
    sq_codes: Sharded          # [nlist_pad, cap, d_pad] u8
    sq_norms: Sharded          # [nlist_pad, cap] f32
    sq_scale: Sharded          # [d] f32, replicated
    sq_off: Sharded            # [d] f32, replicated
    centroids: Sharded         # [nlist_pad, d] f32, sharded axis 0
    cent_norms: Sharded        # [nlist_pad] f32


def shard_ivfsq(mesh: Mesh, state: IVFState, centroids, cent_norms,
                sq_codes, sq_norms, sq_scale, sq_off,
                cap_eff: int = 0) -> ShardedIVFSQ:
    """Distribute the SQ8 capacity tier over the mesh (same contiguous
    list split as shard_ivfpq; docids/vids stay global)."""
    s = mesh.shape[LIST_AXIS]
    nlist = state.nlist
    l_pad = -(-nlist // s) * s
    vids, docids = state.vids, state.docids
    # the scan width: the caller's ladder watermark, never wider than the
    # sidecar's own allocation
    eff = min(cap_eff or sq_codes.shape[1], sq_codes.shape[1])
    if eff < vids.shape[1]:
        vids, docids = vids[:, :eff], docids[:, :eff]
    if eff < sq_codes.shape[1]:
        sq_codes, sq_norms = sq_codes[:, :eff], sq_norms[:, :eff]
    cents, cnorms = _shard_lists(mesh, centroids, l_pad)
    return ShardedIVFSQ(
        vids=_rows(mesh, _pad_axis0(vids, l_pad, -1)),
        docids=_rows(mesh, _pad_axis0(docids, l_pad, -1)),
        lens=_rows(mesh, _pad_axis0(state.lens, l_pad)),
        sq_codes=_rows(mesh, _pad_axis0(sq_codes, l_pad)),
        sq_norms=_rows(mesh, _pad_axis0(sq_norms, l_pad)),
        sq_scale=_replicated(mesh, sq_scale.float()),
        sq_off=_replicated(mesh, sq_off.float()),
        centroids=cents, cent_norms=cnorms)


def _local_ivfsq_search(sh: ShardedIVFSQ, qi: int, queries, penalty,
                        live_n, *, nprobe, local_probe, k, metric,
                        use_validity=False):
    s = len(queries)
    cents = [sh.centroids.local(qi, i) for i in range(s)]
    sel = _probe_select(queries, cents,
                        [sh.cent_norms.local(qi, i) for i in range(s)],
                        nprobe=nprobe, local_probe=local_probe,
                        metric=metric)
    # 3. exact SQ8 scan of the selected local lists (B1, fold 1; the
    # centroid term added back per probe), the mask bias folded into
    # the norms stream; then the exact local top-k
    rd, rdoc, rvid = [], [], []
    for i, (sel_d, sel_ids, sel_ok) in enumerate(sel):
        vids, docids = sh.vids.local(qi, i), sh.docids.local(qi, i)
        lens = sh.lens.local(qi, i)
        cap = vids.shape[1]
        bias_l = list_bias(docids, lens, cap, penalty=penalty[i],
                           live_n=live_n if use_validity else None)
        dist = grouped_sq_scan(sh.sq_codes.local(qi, i),
                               sh.sq_norms.local(qi, i), lens, sel_ids,
                               queries[i], sh.sq_scale.local(qi, i),
                               sh.sq_off.local(qi, i), centroids=cents[i],
                               metric=metric, bias=bias_l)
        d, doc, vid = _select_late(_mask_unselected(dist, sel_ok), sel_ids,
                                   docids, vids, cap, k, exact=True)
        rd.append(d)
        rdoc.append(doc)
        rvid.append(vid)
    # 4. ONE merge of k: the distances are already exact
    md, mdoc, mvid = _merge(rd, (rdoc, rvid), k)[0]
    dead = md >= BIG
    return md, mdoc.masked_fill(dead, -1), mvid.masked_fill(dead, -1)


def sharded_ivfsq_search_fn(mesh: Mesh, *, nprobe: int, k: int,
                            metric: str = "l2",
                            local_probe: Optional[int] = None,
                            use_validity: bool = False):
    """The sharded SQ8 capacity search for a fixed geometry.

    Returned fn: (sharded: ShardedIVFSQ, queries [B, d], penalty [N_cap],
    live_n=0) → (dists [B, k], docids [B, k], vids [B, k]); the penalty
    is doc-aligned and replicated."""
    local_probe = _local_probe(nprobe, mesh.shape[LIST_AXIS], local_probe)

    def search(sharded: ShardedIVFSQ, queries, penalty, live_n=0):
        def row(qi, q):
            pen = [penalty.to(dev) for dev in mesh.devices[qi]]
            return _local_ivfsq_search(
                sharded, qi, q, pen, int(live_n), nprobe=nprobe,
                local_probe=local_probe, k=k, metric=metric,
                use_validity=use_validity)

        return _by_query_block(mesh, row, queries)

    return search


# ----------------------------------------------------------------------
# sharded DENSE scan (reconstruction mirror row-sharded over "l")
# ----------------------------------------------------------------------

class ShardedDense(NamedTuple):
    """Dense-mode serving snapshot: recon + raw rows sharded over "l"."""

    recon: Sharded           # [R_pad, d] sharded axis 0
    recon_norms: Sharded     # [R_pad]: norms + validity, BIG past rows
    raw: Sharded             # [R_pad, d] sharded axis 0 (rerank source)
    rows_per_shard: int


def shard_dense(mesh: Mesh, recon, recon_norms, recon_valid,
                raw) -> ShardedDense:
    """Row-shard the dense-scan state.  recon_valid folds into the norms
    (adding BIG poisons padded and tombstoned rows)."""
    s = mesh.shape[LIST_AXIS]
    rows = recon.shape[0]
    r_pad = -(-rows // s) * s
    norms = recon_norms.float() + recon_valid.float()
    raw_pad = raw.new_zeros((r_pad, raw.shape[1]))
    m = min(rows, raw.shape[0])
    raw_pad[:m] = raw[:m]
    return ShardedDense(
        recon=_rows(mesh, _pad_axis0(recon, r_pad)),
        recon_norms=_rows(mesh, _pad_axis0(norms, r_pad, BIG)),
        raw=_rows(mesh, raw_pad), rows_per_shard=r_pad // s)


def sharded_dense_search_fn(mesh: Mesh, *, recall_num: int, k: int,
                            metric: str = "l2", rerank: bool = True,
                            rows_per_shard: int,
                            recall_target: float = 0.95):
    """Dense scan over row-sharded reconstructions: a local GEMM and
    exact top-r per shard (ops/dense_scan's tiles; `recall_target` is
    the JAX package's approx_min_k knob and changes nothing), the merge,
    and the owner-computes exact rerank.

    Returned fn: (sharded: ShardedDense, queries [B, d] (rotated),
    penalty [R_pad] vid-aligned, queries_raw [B, d]) → (dists [B, k],
    vids [B, k])."""
    r = max(recall_num, k)
    scale = -1.0 if metric == "ip" else -2.0

    def search(sd: ShardedDense, queries, penalty, queries_raw):
        # norms + penalty fused into ONE [R] bias, before the shards
        pen = _rows(mesh, penalty.float())
        bias = [[torch.clamp_max(
            pen.local(qi, l) if metric == "ip"
            else sd.recon_norms.local(qi, l) + pen.local(qi, l), BIG)
            for l in range(mesh.shape[LIST_AXIS])]
            for qi in range(mesh.shape[QUERY_AXIS])]

        def row(qi, q_l, q_raw):
            rd, gids = [], []
            for my, q in enumerate(q_l):
                recon_l, b_l = sd.recon.local(qi, my), bias[qi][my]
                qf = q.float()
                q2 = (scale * qf).to(recon_l.dtype)

                def score(s0, e0, q2=q2, recon_l=recon_l, b_l=b_l):
                    return _scores(q2, recon_l[s0:e0]).add_(b_l[s0:e0])

                d, lidx = _tiled_min_k(score, recon_l.shape[0], q2.shape[0],
                                       r)
                if metric != "ip":
                    # the per-query ||q||² is rank-neutral: added after
                    # the select, identically on every shard
                    d = d + (qf * qf).sum(-1, keepdim=True)
                rd.append(torch.clamp_max(d, BIG))
                gids.append(my * rows_per_shard + lidx.clamp_min(0))
            merged = _merge(rd, (gids,), r)
            md, sel = merged[0]
            if not rerank:
                out = md[:, :k]
                return out, torch.where(out >= BIG, -1, sel[:, :k])
            exact = psum([_owner_exact(sd.raw.local(qi, my), q_raw[my], g,
                                       my, rows_per_shard, metric,
                                       torch.ones_like(g, dtype=torch.bool))
                          for my, (_, g) in enumerate(merged)])
            ex = torch.where(md >= BIG, BIG, exact[0])
            pos = torch.arange(r, device=md.device).expand_as(ex)
            ed, eidx = topk_min(ex, pos, k)
            evid = torch.gather(sel, 1, eidx)
            return ed, torch.where(ed >= BIG, -1, evid)

        return _by_query_block(mesh, row, queries, queries_raw)

    return search


# ----------------------------------------------------------------------
# sharded brute-force (FLAT over row-sharded corpus)
# ----------------------------------------------------------------------

def sharded_flat_search_fn(mesh: Mesh, *, k: int, metric: str = "l2",
                           v_per_shard: int):
    """Exact search over a row-sharded corpus: local scan + merge.

    Returned fn: (raw [V_pad, d], norms [V_pad], queries [B, d], penalty
    [V_pad]) → (dists [B, k], ids [B, k]); raw, norms and penalty are
    split over "l" here."""

    def fn(raw, norms, queries, penalty):
        raw, norms, penalty = (_rows(mesh, x) for x in (raw, norms, penalty))

        def row(qi, queries_l):
            ld, lid = [], []
            for my, q in enumerate(queries_l):
                raw_l = raw.local(qi, my)
                d = (-pairwise_ip(q, raw_l) if metric == "ip"
                     else pairwise_l2(q, raw_l, norms.local(qi, my)))
                d = torch.clamp_max(d + penalty.local(qi, my)[None, :], BIG)
                gids = my * v_per_shard + torch.arange(
                    v_per_shard, device=d.device)
                dd, ii = topk_min(d, gids.expand_as(d), k)
                ld.append(dd)
                lid.append(ii)
            out = []
            for d, i in zip(all_gather(ld, 1), all_gather(lid, 1)):
                out.append(topk_min(d, i, k))
            return out[0]

        return _by_query_block(mesh, row, queries)

    return fn


# ----------------------------------------------------------------------
# data-parallel k-means (sharded training step)
# ----------------------------------------------------------------------

def sharded_kmeans_fit(mesh: Mesh, x, init, *, k: int, iters: int = 10):
    """Lloyd iterations with the train set row-sharded over the FULL mesh
    (both axes, row-major): each device assigns its rows and sums them
    per cluster in row order (ops/kmeans._cluster_sums), and the shards'
    (sums, counts) are added in shard order — so two fits from one seed
    give the same bits.  → (centroids [k, d] f32, counts [k] f32) on the
    mesh's first device."""
    devs = [dev for row in mesh.devices for dev in row]
    n_dev = len(devs)
    x = torch.as_tensor(np.asarray(x, np.float32))
    n = x.shape[0]
    per = -(-n // n_dev)
    # the padded rows of the JAX function carry weight 0: they are left
    # out of each shard instead
    xs = [x[i * per:min(n, (i + 1) * per)].to(dev)
          for i, dev in enumerate(devs)]
    init = torch.as_tensor(np.asarray(init, np.float32))
    cents = {dev: init.to(dev) for dev in set(devs)}

    def partial(c_of):
        sums, counts = [], []
        for x_l in xs:
            if x_l.shape[0] == 0:
                s_l = x_l.new_zeros((k, x_l.shape[1]))
                c_l = torch.zeros(k, device=x_l.device)
            else:
                s_l, c_l = _cluster_sums(x_l, assign_nearest(
                    x_l, c_of[x_l.device]), k)
            sums.append(s_l)
            counts.append(c_l.float())
        return psum(sums), psum(counts)

    for _ in range(iters):
        sums, counts = partial(cents)
        new = {}
        for s_l, c_l, x_l in zip(sums, counts, xs):
            dev = x_l.device
            if dev not in new:
                c = cents[dev]
                upd = s_l / c_l.clamp_min(1.0)[:, None]
                new[dev] = torch.where(c_l[:, None] > 0, upd, c)
        cents = new
    counts = psum([torch.bincount(assign_nearest(x_l, cents[x_l.device]),
                                  minlength=k).float() for x_l in xs])
    first = devs[0]
    return cents[first], counts[0].to(first)
