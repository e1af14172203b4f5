"""Top-k helpers, smaller-is-better (counterpart of gamma_tpu/ops/topk.py).

`torch.topk` does not order ties; callers that compare against the JAX
package compare the distances of the chosen ids, not id sets.
"""

from __future__ import annotations

import torch

from gamma_tpu_torch.ops.distances import BIG


def topk_min(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k smallest along the last axis → (vals, ids), ascending.
    If k exceeds the candidate count, results are padded with (BIG, -1)."""
    size = dists.shape[-1]
    k_eff = min(k, size)
    vals, idx = torch.topk(dists, k_eff, dim=-1, largest=False,
                           sorted=True)
    out_ids = torch.gather(ids, -1, idx)
    if k_eff < k:
        pad = list(vals.shape[:-1]) + [k - k_eff]
        vals = torch.cat([vals, vals.new_full(pad, BIG)], dim=-1)
        out_ids = torch.cat([out_ids, out_ids.new_full(pad, -1)], dim=-1)
    return vals, out_ids


def merge_topk(d1, i1, d2, i2, k: int):
    """Merge two (dist, id) top-k sets along the last axis."""
    return topk_min(torch.cat([d1, d2], dim=-1),
                    torch.cat([i1, i2], dim=-1), k)
