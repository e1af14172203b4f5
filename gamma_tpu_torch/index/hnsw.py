"""HNSW-equivalent navigable neighbour graph (counterpart of
gamma_tpu/index/hnsw.py).

Reference: index/impl/hnswlib/gamma_index_hnswlib.{h,cc} — vendored
hnswlib graph ANN over MemoryRawVector with per-query efSearch.

The JAX package re-derives hnswlib's sequential insert-time construction
as batched device work, and this port keeps that design:

  * BUILD: a kNN graph from a tiled self-join (exact below
    CLUSTER_BUILD_N rows, inside two overlapping k-means partitions
    above it), alpha-pruned (Vamana/DiskANN-style relative-neighbourhood
    pruning, the batched analog of hnswlib's getNeighborsByHeuristic2),
    plus reverse and long-range edges built on the host.
  * SEARCH: a multi-entry best-first beam search with a fixed number of
    steps: each step expands the `fanout` best unexpanded beam entries,
    gathers their neighbour lists, scores the candidates with one
    batched product, dedups by an id sort and keeps the best efSearch.
    A strided entry sample stands in for HNSW's upper layers.
  * REALTIME: the graph covers vids [0, n_nodes); newer vids up to the
    store's flushed count are covered by an exact flat scan of the tail,
    merged into the beam's results.  Deletes tombstone through the
    penalty (hnswlib markDelete analog).

The JAX package's `jax.jit` functions are plain functions on tensors
here, and its `lax.fori_loop` / `lax.map` bodies Python loops over
batched torch ops.  Where the JAX code takes `jax.lax.approx_min_k`
(approximate on a TPU only; on the CPU it is exact), the port takes the
exact `torch.topk`.  None of it is a Pallas kernel in the JAX package,
so none is a hand-written kernel here.

What a search reads, the graph `links` and its extent `n_nodes`, is
published as one snapshot (`RetrievalModel._publish` / `_read`); a
rebuild writes into a new tensor and never into the published one.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from gamma_tpu_torch.config import MetricType, SearchParams
from gamma_tpu_torch.index.model import RetrievalModel
from gamma_tpu_torch.index.registry import register_model
from gamma_tpu_torch.ops.distances import (BIG, l2_norms, pairwise_dist,
                                           pairwise_l2)
from gamma_tpu_torch.ops.flat_scan import flat_search
from gamma_tpu_torch.ops.topk import merge_topk
from gamma_tpu_torch.vector.raw_store import RawVectorStore

NODE_PAD = 8192
BUILD_CHUNK = 4096
# inner (corpus) axis of the kNN self-join is tiled so the distance
# transient stays [BUILD_CHUNK, INNER_CHUNK] f32 = 1 GB regardless of N
INNER_CHUNK = 65536
# above this node count, growth rebuilds are INCREMENTAL (kNN of the new
# rows only + reverse-edge patch) instead of a full re-run
INCR_THRESHOLD = 262144
# above this corpus size, the kNN graph builds from a CLUSTERED partition
# self-join (two overlapping k-means partitions, exact kNN inside each
# cluster) instead of the exact all-pairs join: O(N·capm·d) vs O(N²d)
CLUSTER_BUILD_N = 300_000
CLUSTER_TARGET = 3072       # mean rows per cluster
CLUSTER_CAP_X = 2.0         # member-slot headroom over the mean
# the alpha prune's [rows, r, r, d] f32 difference is built this many
# bytes at a time (XLA fuses it away; eager torch materialises it)
PRUNE_BYTES = 1 << 29
# the beam's dedup key is id*2 + flag in int32 in the JAX package
MAX_NODES = 1 << 30


def _ceil(n: int, q: int) -> int:
    return -(-n // q) * q


def _smallest(d: torch.Tensor, k: int):
    """The k smallest entries along the last axis, ascending →
    (vals, idx int64)."""
    return torch.topk(d, k, dim=-1, largest=False, sorted=True)


def _fit(pen: torch.Tensor, n: int) -> torch.Tensor:
    """The row penalty cut, or padded with BIG, to n rows."""
    if pen.shape[0] < n:
        return torch.nn.functional.pad(pen, (0, n - pen.shape[0]),
                                       value=BIG)
    return pen[:n]


def _build_knn(x, norms, valid_pen, row0: int, *, r: int, metric: str,
               n_chunks: int, n_inner: int, ic: int) -> torch.Tensor:
    """Exact kNN of x[row0 : row0 + n_chunks*BUILD_CHUNK) against ALL of
    x [N_pad, d] (N_pad = n_inner*ic), both axes tiled with a running
    top-k merge so no [chunk, N] transient materialises.  valid_pen
    [N_pad] poisons padding rows.  → links [rows, r] int32."""
    dev = x.device
    out = []
    local = torch.arange(BUILD_CHUNK, device=dev)
    for ci in range(n_chunks):
        s = row0 + ci * BUILD_CHUNK
        xc = x[s:s + BUILD_CHUNK]
        bd = torch.full((BUILD_CHUNK, r + 1), BIG, dtype=torch.float32,
                        device=dev)
        bi = torch.full((BUILD_CHUNK, r + 1), -1, dtype=torch.int64,
                        device=dev)
        for ii in range(n_inner):
            t = ii * ic
            d = pairwise_dist(xc, x[t:t + ic], metric,
                              None if metric == "ip" else norms[t:t + ic])
            d += valid_pen[None, t:t + ic]
            # drop self: row s + j sits at column s + j - t of this tile
            col = s + local - t
            on = (col >= 0) & (col < ic)
            d[local[on], col[on]] = BIG
            vals, idx = _smallest(d, min(r + 1, ic))
            del d
            cw = vals.shape[1]
            if cw < r + 1:
                vals = torch.nn.functional.pad(vals, (0, r + 1 - cw),
                                               value=BIG)
                idx = torch.nn.functional.pad(idx, (0, r + 1 - cw))
            bd, bi = merge_topk(bd, bi, vals, idx + t, r + 1)
        vals, idx = bd[:, :r], bi[:, :r]
        out.append(torch.where(vals >= BIG, -1, idx).to(torch.int32))
    return torch.cat(out, 0)


def _assign_top2(x, cents, cnorms, *, chunk: int = 8192) -> torch.Tensor:
    """Top-2 cluster assignment per row, chunked.  → [N_pad, 2] int32."""
    out = []
    for s in range(0, x.shape[0], chunk):
        d = pairwise_l2(x[s:s + chunk].float(), cents, cnorms)
        out.append(_smallest(d, 2)[1].to(torch.int32))
    return torch.cat(out, 0)


def _group_members(assign, valid, *, ncl: int, capm: int) -> torch.Tensor:
    """Invert row→cluster into member lists [ncl, capm] int32 (-1 pad);
    rows past a cluster's capm slots are dropped (they still appear as
    members of their OTHER partition's cluster)."""
    n = assign.shape[0]
    dev = assign.device
    li = torch.where(valid, assign.long(), ncl)
    order = torch.argsort(li, stable=True)
    sl = li[order]
    idx = torch.arange(n, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sl[1:] != sl[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    rank = idx - run_start
    keep = rank < capm                  # the JAX scatter drops the rest
    members = torch.full((ncl + 1, capm), -1, dtype=torch.int32, device=dev)
    members[sl[keep], rank[keep]] = order[keep].to(torch.int32)
    return members[:ncl]


def _cluster_pass(x, norms, members, *, r: int, metric: str, ncl: int):
    """Exact kNN inside each cluster: one [capm, capm] self-join per
    cluster, results scattered back by global row id.
    → (vals [N_pad, r+1] f32, ids [N_pad, r+1] int32)."""
    n_pad = x.shape[0]
    capm = members.shape[1]
    dev = x.device
    gv = torch.full((n_pad, r + 1), BIG, dtype=torch.float32, device=dev)
    gi = torch.full((n_pad, r + 1), -1, dtype=torch.int32, device=dev)
    diag = torch.arange(capm, device=dev)
    for ci in range(ncl):
        mlist = members[ci].long()
        msafe = mlist.clamp_min(0)
        rows = x[msafe]
        d = pairwise_dist(rows, rows, metric,
                          None if metric == "ip" else norms[msafe])
        d += torch.where(mlist < 0, BIG, 0.0)[None, :]
        d[diag, diag] = BIG                                 # drop self
        vals, idx = _smallest(d, r + 1)
        del d
        gids = torch.where(vals >= BIG, -1, mlist[idx])
        live = mlist >= 0                  # the JAX scatter drops padding
        tgt = mlist[live]
        gv[tgt] = vals.clamp_max(BIG)[live]
        gi[tgt] = gids[live].to(torch.int32)
    return gv, gi


def _merge_dedup(v1, i1, v2, i2, *, r: int):
    """Merge two candidate sets per row, dedup by id, keep best r.
    → (ids [n, r] int32, vals [n, r] f32)."""
    av = torch.cat([v1, v2], 1)
    ai = torch.cat([i1, i2], 1).long()
    order = torch.argsort(ai, dim=1, stable=True)
    si = torch.gather(ai, 1, order)
    sv = torch.gather(av, 1, order)
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[:, 1:] = si[:, 1:] == si[:, :-1]
    sv = torch.where(dup | (si < 0), BIG, sv)
    nv, sel = _smallest(sv, r)
    out_i = torch.gather(si, 1, sel)
    return torch.where(nv >= BIG, -1, out_i).to(torch.int32), nv


def _patch_reverse(links, new_ids, new_out, slots) -> torch.Tensor:
    """Insert each new node into ONE reverse slot of every out-neighbour
    (bounded degree, recency-biased: the batched analog of hnswlib's
    capped bidirectional connect).  new_out [m, r] are the new nodes'
    out-links; slots [m] picks the reverse column per new node.  Returns
    a new tensor; `links` is left as it is.  Where two new nodes land on
    one (dst, col) slot the JAX scatter, applied in order, keeps the
    later, larger id: here a max over the writes alone, which gives that
    winner on any device."""
    m, r = new_out.shape
    width = links.shape[1]
    dst = new_out.long().reshape(-1)
    src = new_ids.long()[:, None].expand(m, r).reshape(-1)
    col = slots.long()[:, None].expand(m, r).reshape(-1)
    ok = dst >= 0                          # the JAX scatter drops -1 edges
    flat = links.clone().reshape(-1)
    flat.scatter_reduce_(0, dst[ok] * width + col[ok],
                         src[ok].to(links.dtype), "amax",
                         include_self=False)
    return flat.reshape(links.shape)


def _alpha_prune(nbr_vecs, nbr_ids, nbr_dists, *, alpha: float = 1.2):
    """Vamana-style pruning, batched over nodes: drop neighbour j if a
    kept closer neighbour i satisfies alpha^2 * d2(i, j) < d2(node, j).
    Pruned entries become -1 (order preserved, closest first).  The
    [n, r, r] neighbour distances are the squared differences, built
    PRUNE_BYTES at a time (the Gram form rounds otherwise and flips
    decisions at near-ties)."""
    n, r = nbr_ids.shape
    step = max(1, PRUNE_BYTES // (4 * r * r * nbr_vecs.shape[2]))
    dnn = torch.cat([
        ((v[:, :, None, :] - v[:, None, :, :]) ** 2).sum(-1)
        for v in nbr_vecs.split(step)], 0)                  # [n, r, r]
    keep = torch.zeros((n, r), dtype=torch.bool, device=nbr_ids.device)
    keep[:, 0] = nbr_ids[:, 0] >= 0
    a2 = alpha * alpha
    for j in range(1, r):
        dom = keep & (dnn[:, :, j] * a2 < nbr_dists[:, j][:, None])
        keep[:, j] = ~dom.any(1) & (nbr_ids[:, j] >= 0)
    return torch.where(keep, nbr_ids, -1)


def _beam_search(vectors, vec_norms, links, queries, penalty, *, ef: int,
                 k: int, iters: int, metric: str, entry_stride: int,
                 fanout: int = 8):
    """Batched best-first beam search with expansion flags (the form of
    hnswlib's searchBaseLayer that the JAX package runs): per step only
    the `fanout` best UNEXPANDED beam entries expand (gather their
    neighbour lists, one batched product scores them); an expanded flag
    rides every beam slot so dedup keeps the expanded copy and no node is
    expanded twice.  → (dists [B, k] f32, ids [B, k] int64)."""
    b = queries.shape[0]
    dev = queries.device
    entries = torch.arange(0, vectors.shape[0], entry_stride, device=dev)
    ed = pairwise_dist(queries, vectors[::entry_stride], metric,
                       None if metric == "ip"
                       else vec_norms[::entry_stride])
    ed = ed + penalty[::entry_stride][None, :]
    m = min(ef, entries.shape[0])
    beam_d, eidx = _smallest(ed, m)
    beam_i = torch.where(beam_d >= BIG, -1, entries[eidx])
    if m < ef:
        beam_d = torch.nn.functional.pad(beam_d, (0, ef - m), value=BIG)
        beam_i = torch.nn.functional.pad(beam_i, (0, ef - m), value=-1)
    beam_x = torch.zeros((b, ef), dtype=torch.int64, device=dev)

    qf = queries.float()
    qn = (qf * qf).sum(-1, keepdim=True)
    for _ in range(iters):
        # pick the fanout best unexpanded live entries
        sel_d = torch.where((beam_x > 0) | (beam_i < 0), BIG, beam_d)
        sel_v, sel = _smallest(sel_d, fanout)                 # [B, F]
        sel_i = torch.gather(beam_i, 1, sel)
        sel_dead = sel_v >= BIG
        beam_x = beam_x.scatter(1, sel, 1)
        nbrs = links[sel_i.clamp_min(0)].long()               # [B, F, W]
        nbrs = torch.where(((sel_i >= 0) & ~sel_dead)[..., None], nbrs, -1)
        cand = nbrs.reshape(b, -1)                            # [B, F*W]
        safe = cand.clamp_min(0)
        vecs = vectors[safe].float()                          # [B, C, d]
        ip = torch.bmm(vecs, qf[:, :, None])[..., 0]         # "bd,bcd->bc"
        cd = -ip if metric == "ip" else qn - 2.0 * ip + vec_norms[safe]
        cd = (cd + penalty[safe]).clamp_max(BIG)
        cd = torch.where(cand < 0, BIG, cd)
        alld = torch.cat([beam_d, cd], 1)
        alli = torch.cat([beam_i, cand], 1)
        allx = torch.cat([beam_x, torch.zeros_like(cand)], 1)
        # dedup: sort by (id, expanded-first) so the kept copy of a
        # duplicated id is the EXPANDED one (else it would re-expand)
        key = torch.where(alli < 0, 0x7fffffff, alli * 2 + (1 - allx))
        order = torch.argsort(key, dim=1, stable=True)
        si = torch.gather(alli, 1, order)
        sd = torch.gather(alld, 1, order)
        sx = torch.gather(allx, 1, order)
        dup = torch.zeros_like(si, dtype=torch.bool)
        dup[:, 1:] = si[:, 1:] == si[:, :-1]
        sd = torch.where(dup, BIG, sd)
        beam_d, sel2 = _smallest(sd, ef)
        gone = beam_d >= BIG
        beam_i = torch.where(gone, -1, torch.gather(si, 1, sel2))
        beam_x = torch.where(gone, 0, torch.gather(sx, 1, sel2))
    out_d = beam_d[:, :k]
    return out_d, torch.where(out_d >= BIG, -1, beam_i[:, :k])


@register_model("HNSW")
class HNSWIndex(RetrievalModel):
    model_name = "HNSW"
    penalty_space = "row"

    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(raw_store, params)
        p = params or {}
        self.nlinks = int(p.get("nlinks", 32))          # hnswlib M*2
        self.ef_construction = int(p.get("efConstruction", 64))
        self.ef_search_default = int(p.get("efSearch", 64))
        self.beam_fanout = int(p.get("beam_fanout", 8))
        self.beam_iters = p.get("beam_iters")   # None = auto from ef
        self.alpha = float(p.get("alpha", 1.2))
        mt = str(p.get("metric_type", "L2")).upper()
        self.default_metric = (MetricType.INNER_PRODUCT
                               if mt in ("IP", "INNERPRODUCT",
                                         "INNER_PRODUCT")
                               else MetricType.L2)
        # link width = out-edges + reverse edges + long-range edges:
        # reverse edges leave no in-degree-0 node (hnswlib also keeps
        # bidirectional links), long-range random edges join the
        # components a pure kNN graph leaves apart on clustered data
        # (the role of HNSW's upper layers)
        self.n_reverse = max(4, self.nlinks // 2)
        self.n_long = max(4, self.nlinks // 8)
        width = self.nlinks + self.n_reverse + self.n_long
        self.links = torch.full((NODE_PAD, width), -1, dtype=torch.int32,
                                device=raw_store.dev)
        self.n_nodes = 0        # graph covers vids [0, n_nodes)

    def trained(self) -> bool:
        return True             # graph ANN has no offline training phase

    def train(self, x) -> None:
        pass

    def _metric(self) -> str:
        return ("ip" if self.default_metric == MetricType.INNER_PRODUCT
                else "l2")

    @staticmethod
    def _grow_links(links: torch.Tensor, need: int) -> torch.Tensor:
        """A new links tensor holding `links`, its rows doubled until at
        least `need` (the published one is never written)."""
        cap = links.shape[0]
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        if new_cap == cap:
            return links.clone()
        return torch.nn.functional.pad(links, (0, 0, 0, new_cap - cap),
                                       value=-1)

    def _padded_corpus(self, end: int):
        """Device corpus padded for the tiled self-join: n_pad is a
        multiple of the inner chunk ic (= min(INNER_CHUNK, padded end))."""
        dev_rows, dev_norms = self.store.device, self.store.device_norms
        ic = min(INNER_CHUNK, _ceil(max(end, BUILD_CHUNK), BUILD_CHUNK))
        n_pad = _ceil(max(end, BUILD_CHUNK), ic)
        have = min(end, dev_rows.shape[0])
        x = torch.zeros((n_pad, self.store.d), dtype=dev_rows.dtype,
                        device=dev_rows.device)
        x[:have] = dev_rows[:have]
        norms = torch.zeros((n_pad,), dtype=torch.float32,
                            device=dev_rows.device)
        norms[:end] = dev_norms[:end]
        valid_pen = torch.where(
            torch.arange(n_pad, device=x.device) < end, 0.0, BIG)
        return x, norms, valid_pen, n_pad, ic

    def _clustered_knn(self, x, norms, end: int, metric: str,
                       cents: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Approximate kNN graph from two overlapping k-means partitions:
        each row's candidates are the exact kNN inside its top-1 and
        top-2 clusters, merged and deduped.  O(N·capm·d).  `cents`
        replaces the k-means centroids (the JAX package draws another
        init from the same seed; tests inject its centroids)."""
        from gamma_tpu_torch.ops import kmeans as km
        r = self.nlinks
        ncl = max(64, _ceil(end, CLUSTER_TARGET) // CLUSTER_TARGET)
        capm = _ceil(min(16384, int(CLUSTER_CAP_X * end / ncl) + 64), 128)
        if cents is None:
            stride = max(1, end // min(end, 48 * ncl))
            cents, _ = km.kmeans(x[:end:stride].float(), ncl, iters=4,
                                 seed=end)
        cents = cents.float().to(x.device)
        cnorms = l2_norms(cents)
        n_pad = x.shape[0]
        chunk = n_pad
        for c in (8192, 4096, 2048, 1024, 512, 256, 128):
            if n_pad % c == 0:
                chunk = c
                break
        assign2 = _assign_top2(x, cents, cnorms, chunk=chunk)  # [n_pad, 2]
        valid = torch.arange(n_pad, device=x.device) < end
        passes = []
        for pi in range(2):
            members = _group_members(assign2[:, pi], valid,
                                     ncl=ncl, capm=capm)
            passes.append(_cluster_pass(x, norms, members,
                                        r=r, metric=metric, ncl=ncl))
        ids, _ = _merge_dedup(passes[0][0], passes[0][1],
                              passes[1][0], passes[1][1], r=r)
        return ids

    def _knn_out_links(self, x, norms, valid_pen, n_pad, ic, row0: int,
                       end: int, metric: str) -> torch.Tensor:
        """alpha-pruned out-links for rows [row0, end) (row0
        chunk-aligned)."""
        if end > CLUSTER_BUILD_N and row0 == 0:
            links = self._clustered_knn(x, norms, end, metric)
        else:
            n_chunks = _ceil(end - row0, BUILD_CHUNK) // BUILD_CHUNK
            links = _build_knn(x, norms, valid_pen, row0, r=self.nlinks,
                               metric=metric, n_chunks=n_chunks,
                               n_inner=n_pad // ic, ic=ic)
        if self.alpha > 1.0 and metric == "l2":
            # prune in chunks to bound the [c, r, r] intermediate
            pruned = []
            for s in range(0, end - row0, BUILD_CHUNK):
                e = min(end - row0, s + BUILD_CHUNK)
                ids = links[s:e].long()
                node = x[row0 + s:row0 + e].float()
                nbr = x[ids.clamp_min(0)].float()
                nd = ((node[:, None, :] - nbr) ** 2).sum(-1)
                nd = torch.where(ids >= 0, nd, BIG)
                pruned.append(_alpha_prune(nbr, ids, nd,
                                           alpha=self.alpha))
            links = torch.cat(pruned, 0).to(torch.int32)
        return links[: end - row0]

    def _bulk_build(self, end: int) -> None:
        metric = self._metric()
        x, norms, valid_pen, n_pad, ic = self._padded_corpus(end)
        out_np = self._knn_out_links(x, norms, valid_pen, n_pad, ic,
                                     0, end, metric)[:end].cpu().numpy()
        del x, norms, valid_pen                 # before the host work
        # reverse edges (undirected graph: no in-degree-0 nodes)
        r = self.nlinks
        src = np.repeat(np.arange(end, dtype=np.int32), r)
        dst = out_np.reshape(-1)
        ok = dst >= 0
        src, dst = src[ok], dst[ok]
        # nodes nobody lists (in-degree 0) get priority for the capped
        # reverse slots of their own out-neighbours
        indeg = np.bincount(dst, minlength=end)
        stranded = indeg[src] == 0
        order = np.lexsort((~stranded, dst))
        src, dst = src[order], dst[order]
        starts = np.zeros(dst.size, np.int64)
        bnd = np.flatnonzero(np.diff(dst)) + 1
        starts[bnd] = bnd
        np.maximum.accumulate(starts, out=starts)
        rank = np.arange(dst.size) - starts
        keep = rank < self.n_reverse
        rev = np.full((end, self.n_reverse), -1, np.int32)
        rev[dst[keep], rank[keep]] = src[keep]
        # long-range edges: a random permutation per slot (deterministic)
        lrng = np.random.default_rng(end)
        longe = np.stack([lrng.permutation(end).astype(np.int32)
                          for _ in range(self.n_long)], axis=1)
        longe[longe == np.arange(end, dtype=np.int32)[:, None]] = -1
        full = np.concatenate([out_np, rev, longe], axis=1)
        # final sweep: force-link any node still unreferenced
        for _ in range(4):
            indeg = np.bincount(full[full >= 0].ravel(), minlength=end)
            left = np.flatnonzero(indeg == 0)
            if left.size == 0:
                break
            for t, j in enumerate(left):
                nbrs = out_np[j][out_np[j] >= 0]
                if nbrs.size == 0:
                    continue
                i = int(nbrs[t % nbrs.size])
                full[i, r + (t % self.n_reverse)] = j
        (links,) = self._read("links")
        links = self._grow_links(links, end)
        links[:end] = torch.from_numpy(full).to(links.device)
        self._publish(links=links, n_nodes=end)

    def _incremental_build(self, end: int) -> None:
        """Merge rows [n_nodes, end) into the existing graph WITHOUT the
        full re-run (hnswlib likewise inserts incrementally): kNN of the
        new rows against the whole corpus gives their out-links; each new
        node is then scattered into one reverse slot of every
        out-neighbour so old nodes can reach it."""
        metric = self._metric()
        links, n_nodes = self._read("links", "n_nodes")
        row0 = (n_nodes // BUILD_CHUNK) * BUILD_CHUNK
        x, norms, valid_pen, n_pad, ic = self._padded_corpus(end)
        out = self._knn_out_links(x, norms, valid_pen, n_pad, ic,
                                  row0, end, metric)       # [m, r]
        del x, norms, valid_pen
        m = end - row0
        r = self.nlinks
        # long-range edges keep the small-world shortcuts for new rows
        lrng = np.random.default_rng(end)
        longe = lrng.integers(0, end, size=(m, self.n_long)).astype(
            np.int32)
        ids_np = np.arange(row0, end, dtype=np.int32)
        longe[longe == ids_np[:, None]] = -1
        rev = np.full((m, self.n_reverse), -1, np.int32)
        dev = links.device
        links = self._grow_links(links, end)
        links[row0:end] = torch.cat(
            [out, torch.from_numpy(rev).to(dev),
             torch.from_numpy(longe).to(dev)], 1)
        new_ids = torch.from_numpy(ids_np).to(dev)
        slots = torch.from_numpy(r + (ids_np % self.n_reverse)).to(dev)
        links = _patch_reverse(links, new_ids, out, slots)
        self._publish(links=links, n_nodes=end)

    def add(self, x, vids: np.ndarray, docids: np.ndarray) -> None:
        """Growth-triggered batch rebuild; the tail between rebuilds is
        covered by the flat scan in search()."""
        hi = int(np.max(vids)) + 1 if len(vids) else 0
        # only the rebuild EXTENT is clamped to the flushed device mirror;
        # the watermark must advance unconditionally or the pump loop
        # (`while indexed_count < store.n`) livelocks when docs land
        # between flush_device() and the pump.  Rows in [flushed, hi) are
        # covered at search time by the flat tail scan once they flush.
        build_hi = min(hi, self.store.flushed)
        if build_hi > max(4 * self.nlinks, int(self.n_nodes * 1.25)):
            if build_hi >= MAX_NODES:
                raise ValueError(f"HNSW: {build_hi} nodes; the beam's "
                                 f"dedup key holds fewer than {MAX_NODES}")
            if build_hi > CLUSTER_BUILD_N:
                # at multi-100k scale a FULL clustered rebuild is
                # O(N·capm·d): cheaper than exact new-vs-all, and it
                # keeps graph quality; amortised over 1.25x growth steps
                self._bulk_build(build_hi)
            elif self.n_nodes >= INCR_THRESHOLD:
                self._incremental_build(build_hi)
            else:
                self._bulk_build(build_hi)
        self.indexed_count = max(self.indexed_count, hi)

    def delete(self, vids) -> None:
        pass   # deletes arrive via the penalty array (markDelete analog)

    def search(self, queries, penalty_by_row, sp: SearchParams, k: int,
               dist_range=None, validity_n=None):
        metric = self.metric_name(sp, self.default_metric)
        links, n_nodes = self._read("links", "n_nodes")
        # the flushed count first: every later mirror holds its rows
        flushed = self.store.flushed
        vectors, vec_norms = self.store.device, self.store.device_norms
        rows_now = min(vectors.shape[0], vec_norms.shape[0])
        if n_nodes < max(4 * self.nlinks, 256):
            d, rows = flat_search(vectors[:rows_now], vec_norms[:rows_now],
                                  queries, _fit(penalty_by_row, rows_now),
                                  dist_range, k=k, metric=metric)
            return d, rows, rows
        ef = max(int(sp.ef_search or self.ef_search_default), k)
        cap = min(links.shape[0], rows_now)
        pen = _fit(penalty_by_row, cap)
        row = torch.arange(cap, device=pen.device)
        # graph rows only; the tail is handled by the flat merge below
        pen_graph = torch.where(row < n_nodes, pen, BIG)
        # entry density scales with ef: enough samples that every basin
        # of attraction gets one (on clustered data the beam converges
        # inside the basins its entries hit)
        stride = max(1, n_nodes // max(8192, 16 * ef))
        # best-first with visited flags: total expansions = iters*fanout;
        # ~1.5x ef expansions matches hnswlib's convergence point, plus a
        # log(N) floor so deep basins stay reachable
        fanout = self.beam_fanout
        iters = (int(self.beam_iters) if self.beam_iters
                 else max(int(np.ceil(np.log2(max(n_nodes, 2)))) - 4,
                          (3 * ef) // (2 * fanout) + 2))
        d, ids = _beam_search(
            vectors[:cap], vec_norms[:cap], links[:cap], queries, pen_graph,
            ef=ef, k=k, iters=iters, metric=metric, entry_stride=stride,
            fanout=fanout)
        if flushed > n_nodes:
            # realtime tail: exact scan of [n_nodes, flushed)
            tail_pen = torch.where(row >= n_nodes, pen, BIG)
            td, tids = flat_search(vectors[:cap], vec_norms[:cap],
                                   queries, tail_pen, dist_range,
                                   k=k, metric=metric)
            d, ids = merge_topk(d, ids, td, tids, k)
        return d, ids, ids

    # ---- persistence ----

    def dump(self, path: str) -> None:
        links, n_nodes = self._read("links", "n_nodes")
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, f"{self.store.name}.hnsw.npz"),
                 links=links[:n_nodes].cpu().numpy(),
                 n_nodes=np.array(n_nodes))

    def load(self, path: str) -> int:
        f = os.path.join(path, f"{self.store.name}.hnsw.npz")
        if not os.path.exists(f):
            return 0
        z = np.load(f)
        n = int(z["n_nodes"])
        (links,) = self._read("links")
        links = self._grow_links(links, max(n, 1))
        if n:
            links[:n] = torch.from_numpy(
                np.asarray(z["links"], np.int32)).to(links.device)
        self._publish(links=links, n_nodes=n)
        self.indexed_count = n
        return n

    def mem_bytes(self) -> int:
        (links,) = self._read("links")
        return int(links.numel() * 4)
