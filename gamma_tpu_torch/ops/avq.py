"""Anisotropic vector quantization, ScaNN's score-aware PQ training
(counterpart of gamma_tpu/ops/avq.py).

Reference role: index/impl/scann/ — the reference vendors Google's ScaNN
as the VEARCH retrieval type; its core technique is the anisotropic
loss of "Accelerating Large-Scale Inference with Anisotropic Vector
Quantization" (Guo et al., 2020): for MIPS, reconstruction error
PARALLEL to the datapoint hurts inner-product ranking more than
orthogonal error, so the k-means objective is
    l(x, c) = h_par * ||P_x (x-c)||^2 + h_orth * ||(I-P_x)(x-c)||^2
            = h_orth * ||x-c||^2 + (h_par - h_orth) * (x_hat . (x-c))^2
with x_hat the ORIGINAL datapoint direction (kept when quantizing
residuals), applied per PQ subspace as the JAX package does:
  * assignment: one [n, ksub] product for ||x-c||^2 and one for x_hat.c;
  * update: per centroid the closed form A_k c = b_k with
      A_k = n_k * I + (eta - 1) * sum x_hat x_hat^T
      b_k = eta * sum x
    whose sums are products with the one-hot assignment (never
    index_add_, whose atomics add in an order that changes from run to
    run on the card), then one batched solve of [dsub, dsub] systems.

eta = h_par / h_orth follows the paper's threshold rule:
eta(T) = (d-1) * T^2 / (1 - T^2), default T = 0.2.
"""

from __future__ import annotations

from typing import Optional

import torch

from gamma_tpu_torch.ops import pq as pq_ops


def eta_from_threshold(t: float, d: int) -> float:
    """Guo et al. Theorem 3.2 weighting for score threshold T."""
    t2 = min(max(t * t, 1e-6), 0.99)
    return (d - 1) * t2 / (1.0 - t2)


def _aniso_cost(x, xhat, cents, eta: float) -> torch.Tensor:
    """x / xhat [n, dsub], cents [ksub, dsub] → loss [n, ksub]."""
    d2 = ((x * x).sum(1)[:, None] - 2.0 * x @ cents.T
          + (cents * cents).sum(1)[None, :])
    par = ((xhat * x).sum(1)[:, None] - xhat @ cents.T) ** 2
    return d2 + (eta - 1.0) * par


def _aniso_assign(x, xhat, cents, *, eta: float) -> torch.Tensor:
    """The least-loss centroid of each row (first on ties) → [n] int64."""
    return torch.argmin(_aniso_cost(x, xhat, cents, eta), dim=1)


def _aniso_update(x, xhat, assign, *, ksub: int, eta: float):
    """Closed-form weighted centroid update → (cents [ksub, dsub],
    counts [ksub] f32).  The per-centroid sums are products with the
    one-hot assignment, so they add in one fixed order."""
    n, dsub = x.shape
    onehot = torch.nn.functional.one_hot(assign, ksub).float()   # [n, ksub]
    counts = onehot.sum(0)                                       # [ksub]
    b = eta * (onehot.T @ x)                                     # [ksub, dsub]
    outer = (onehot.T @ (xhat[:, :, None] * xhat[:, None, :]).reshape(
        n, dsub * dsub)).reshape(ksub, dsub, dsub)
    eye = torch.eye(dsub, dtype=torch.float32, device=x.device)
    a = (counts[:, None, None] * eye[None] + (eta - 1.0) * outer
         + 1e-6 * eye[None])
    cents = torch.linalg.solve(a, b[:, :, None])[:, :, 0]
    return cents, counts


def _split_dirs(x: torch.Tensor, dirs: torch.Tensor, M: int):
    """Rows and their unit directions split into M subspaces →
    (sub [n, M, dsub], xhat [n, M, dsub]), both f32."""
    sub = pq_ops.split_subspaces(x.float(), M)
    dsub = pq_ops.split_subspaces(dirs.float(), M)
    xhat = dsub / torch.linalg.vector_norm(
        dsub, dim=-1, keepdim=True).clamp_min(1e-12)
    return sub, xhat


def train_avq(x: torch.Tensor, M: int, *,
              dirs: Optional[torch.Tensor] = None, nbits: int = 8,
              eta: Optional[float] = None, threshold: float = 0.2,
              iters: int = 10, seed: int = 0) -> pq_ops.PQCodebooks:
    """Train anisotropic PQ codebooks on x [n, d].  `dirs` carries the
    datapoint directions the loss is anisotropic about (defaults to x;
    pass the ORIGINAL rotated vectors when x holds residuals).
    Initialization = plain PQ k-means, then anisotropic Lloyd steps,
    each subspace in turn; an empty centroid keeps its place."""
    ksub = 1 << nbits
    d = x.shape[-1]
    if eta is None:
        eta = eta_from_threshold(threshold, d)
    if dirs is None:
        dirs = x
    base = pq_ops.train_pq(x, M, nbits=nbits, iters=6, seed=seed)
    sub, xhat = _split_dirs(x, dirs, M)
    cbs = []
    for m in range(M):
        xm, xhm = sub[:, m].contiguous(), xhat[:, m].contiguous()
        cents = base.codebooks[m]
        for _ in range(iters):
            assign = _aniso_assign(xm, xhm, cents, eta=float(eta))
            new, counts = _aniso_update(xm, xhm, assign, ksub=ksub,
                                        eta=float(eta))
            cents = torch.where(counts[:, None] > 0, new, cents)
        cbs.append(cents)
    return pq_ops.codebooks_from(torch.stack(cbs))      # [M, ksub, dsub]


def encode_avq(pq: pq_ops.PQCodebooks, x: torch.Tensor, dirs: torch.Tensor,
               *, M: int, eta: float, chunk: int = 4096) -> torch.Tensor:
    """Anisotropic-loss encoding (the indexing-time counterpart of the
    training assignment), `chunk` rows at a time so the [chunk, M, ksub]
    losses stay small → codes u8 [n, M]."""
    sub, xhat = _split_dirs(x, dirs, M)
    cb = pq.codebooks
    cbn = (cb * cb).sum(-1)                             # [M, ksub]
    out = torch.empty((sub.shape[0], M), dtype=torch.uint8,
                      device=sub.device)
    for s in range(0, sub.shape[0], chunk):
        xs, hs = sub[s:s + chunk], xhat[s:s + chunk]    # [c, M, dsub]
        d2 = ((xs * xs).sum(-1)[..., None]
              - 2.0 * torch.einsum("cmd,mkd->cmk", xs, cb) + cbn[None])
        par = ((hs * xs).sum(-1)[..., None]
               - torch.einsum("cmd,mkd->cmk", hs, cb)) ** 2
        out[s:s + chunk] = torch.argmin(d2 + (eta - 1.0) * par,
                                        dim=-1).to(torch.uint8)
    return out
