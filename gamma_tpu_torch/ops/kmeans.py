"""Lloyd's k-means on the device (counterpart of gamma_tpu/ops/kmeans.py).

Each iteration is one distance GEMM (assignment, chunked over rows
past FLAT_DIST_BYTES) and one centroid update, the sums of each cluster's
rows taken in row order (`_cluster_sums`: a stable sort and a segmented
sum, so two runs from one seed give the same bits; `index_add_` adds with
atomics on a CUDA device, in an order that changes from run to run, and
a few ulps there moved whole centroids after ten iterations).  The JAX
package draws its random init from a PRNG key; here a torch.Generator
seeded the same way draws a different subset, so parity tests inject
the same `init` into `kmeans_fit` / `kmeans_batched_fit`.
"""

from __future__ import annotations

from typing import Optional

import torch

from gamma_tpu_torch.ops.distances import l2_norms, pairwise_l2

# distance-matrix budget per assignment pass: above it the [n, k]
# matrix is built in row chunks
FLAT_DIST_BYTES = 1 << 30


def assign_nearest(x: torch.Tensor, cents: torch.Tensor,
                   cent_norms: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """argmin_k ||x - c_k||^2 → [n] int64 (first minimum on ties),
    with the [n, k] distances built in row chunks of FLAT_DIST_BYTES."""
    cn = l2_norms(cents) if cent_norms is None else cent_norms
    n, k = x.shape[0], cents.shape[0]
    rows = max(1, FLAT_DIST_BYTES // (4 * k))
    out = torch.empty(n, dtype=torch.int64, device=x.device)
    for s in range(0, n, rows):
        out[s:s + rows] = torch.argmin(pairwise_l2(x[s:s + rows], cents, cn),
                                       dim=-1)
    return out


def _cluster_sums(x: torch.Tensor, assign: torch.Tensor, k: int):
    """Sum of the rows of x [n, d] assigned to each of k clusters, each
    cluster's rows added in ascending row order → (sums [k, d], counts
    [k] int64).  Ordered, hence the same bits on every run and device
    kind, at about three times index_add_'s time (chip_smoke.py, phase
    D-det, times both): a few milliseconds per training."""
    order = torch.argsort(assign, stable=True)
    counts = torch.bincount(assign, minlength=k)
    sums = torch.segment_reduce(x[order], "sum", lengths=counts,
                                unsafe=True)      # lengths sum to n
    return sums, counts


def _update_centroids(x, assign, k, old_cents):
    """Mean of each cluster; empty clusters keep their centroid."""
    sums, counts = _cluster_sums(x, assign, k)
    counts = counts.float()
    new = sums / counts.clamp_min(1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, old_cents), counts


def _rebalance(cents, counts):
    """Split the biggest clusters into the smallest slots: the j-th
    smallest-count slot moves to the j-th biggest cluster's centroid with
    a tiny symmetric split perturbation, when the donor holds >3x the
    victim's mass and >2x the mean (see the JAX package's _rebalance for
    why redundant slots, not only empty ones, are relocated)."""
    eps = 1e-3
    mean = counts.mean()
    asc = torch.argsort(counts, stable=True)     # victims: smallest first
    desc = asc.flip(0)                           # donors: biggest first
    vcount = counts[asc]
    dcount = counts[desc]
    ok = (((dcount > 3.0 * vcount.clamp_min(1.0)) & (dcount > 2.0 * mean))
          | ((vcount <= 0) & (dcount > 3.0)))
    vmask = torch.zeros_like(ok)
    vmask[asc] = ok
    dmask = torch.zeros_like(ok)
    dmask[desc] = ok
    vrepl = torch.zeros_like(cents)
    vrepl[asc] = torch.where(ok[:, None], cents[desc] * (1.0 + eps), 0.0)
    cents = torch.where(dmask[:, None], cents * (1.0 - eps), cents)
    return torch.where(vmask[:, None], vrepl, cents)


def kmeans_fit(x: torch.Tensor, init: torch.Tensor, *, k: int,
               iters: int = 10, rebalance: int = 2):
    """Run `iters` Lloyd iterations from `init` [k, d], then `rebalance`
    rounds of (Lloyd, split-biggest, Lloyd).  → (centroids [k, d] f32,
    counts [k] f32)."""
    xf = x.float()
    cents = init.float().to(xf.device)

    def lloyd(c):
        return _update_centroids(xf, assign_nearest(xf, c), k, c)

    for _ in range(iters):
        cents = lloyd(cents)[0]
    if rebalance and k > 1:
        for _ in range(rebalance):
            c, counts = lloyd(cents)
            cents = lloyd(_rebalance(c, counts))[0]
    counts = torch.bincount(assign_nearest(xf, cents), minlength=k).float()
    return cents, counts


def kmeans(x: torch.Tensor, k: int, *, iters: int = 10, seed: int = 0,
           rebalance: int = 2):
    """Random-subset init (faiss policy) then fit."""
    n = x.shape[0]
    if k > n:  # degenerate; tile
        init = x.float().repeat(-(-k // n), 1)[:k]
    else:
        g = torch.Generator().manual_seed(seed)
        perm = torch.randperm(n, generator=g)[:k].to(x.device)
        init = x[perm].float()
    return kmeans_fit(x, init, k=k, iters=iters, rebalance=rebalance)


def kmeans_batched_fit(xs: torch.Tensor, inits: torch.Tensor, *, k: int,
                       iters: int = 10):
    """Independent k-means over a leading batch axis, written out as
    batched GEMMs: xs [M, n, dsub], inits [M, k, dsub] →
    (centroids [M, k, dsub], counts [M, k]).  No rebalance: codebooks
    want distortion-optimal centroids."""
    xs = xs.float()
    m, n, dsub = xs.shape
    cents = inits.float().to(xs.device)
    xn = (xs * xs).sum(-1)                                  # [M, n]
    rows = max(1, FLAT_DIST_BYTES // (4 * k * m))
    base = (torch.arange(m, device=xs.device) * k)[:, None]

    def assign(c):
        cn = (c * c).sum(-1)                                # [M, k]
        out = torch.empty((m, n), dtype=torch.int64, device=xs.device)
        for s in range(0, n, rows):
            xc = xs[:, s:s + rows]
            d = (xn[:, s:s + rows, None] - 2.0 * torch.bmm(
                xc, c.transpose(1, 2)) + cn[:, None, :]).clamp_min(0.0)
            out[:, s:s + rows] = torch.argmin(d, dim=-1)
        return out

    def update(c):
        flat = (assign(c) + base).reshape(-1)               # [M*n]
        sums, counts = _cluster_sums(xs.reshape(-1, dsub), flat, m * k)
        counts = counts.float()
        new = sums / counts.clamp_min(1.0)[:, None]
        new = torch.where(counts[:, None] > 0, new, c.reshape(-1, dsub))
        return new.reshape(m, k, dsub), counts.reshape(m, k)

    for _ in range(iters):
        cents = update(cents)[0]
    counts = torch.bincount((assign(cents) + base).reshape(-1),
                            minlength=m * k).float().reshape(m, k)
    return cents, counts
