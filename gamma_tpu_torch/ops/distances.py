"""Pairwise distance primitives (counterpart of gamma_tpu/ops/distances.py).

Both the coarse-quantizer scan and the brute-force flat scan are
(nq x d x N) matrix products with the L2 norm-expansion trick.  Products
run in float32 whatever the operand dtype: a bf16 store mirror is
upcast first, matching the reference's f32 accumulation.
"""

from __future__ import annotations

from typing import Optional

import torch

# "+inf" that survives arithmetic without NaNs (same value as the JAX
# package, so penalty sums saturate identically)
BIG = 3.0e38


def l2_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, f32."""
    xf = x.float()
    return (xf * xf).sum(-1)


def pairwise_ip(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Inner products [nq, n] (higher = better), f32."""
    return q.float() @ x.float().T


def pairwise_l2(q: torch.Tensor, x: torch.Tensor,
                x_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared L2 distances [nq, n] via ||q||^2 - 2 q.x + ||x||^2,
    clamped at 0."""
    qf = q.float()
    cross = pairwise_ip(qf, x)
    if x_norms is None:
        x_norms = l2_norms(x)
    qn = (qf * qf).sum(-1, keepdim=True)
    return (qn - 2.0 * cross + x_norms[None, :]).clamp_min(0.0)


def pairwise_dist(q, x, metric: str, x_norms=None) -> torch.Tensor:
    """Distance where smaller is always better (IP is negated)."""
    if metric == "ip":
        return -pairwise_ip(q, x)
    return pairwise_l2(q, x, x_norms)
