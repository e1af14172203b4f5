"""Validity "penalty" arrays (counterpart of gamma_tpu/ops/penalty.py).

One f32 array `penalty[N_cap]`: 0.0 = valid, BIG = masked.  Deletes,
numeric range predicates and term masks compose into it by a saturating
sum, and the scans add it to the distance.

Updates are copy-on-write: a search may still hold the previous array,
so no function here writes into its input.  Scatter indices outside
[0, len) are dropped explicitly (a CUDA index_put_ with an out-of-range
index is a device-side assert, not a no-op).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gamma_tpu_torch.ops.distances import BIG


def init_validity(cap: int, device=None) -> torch.Tensor:
    """All slots start masked; the engine zeroes slots as docs are added."""
    return torch.full((cap,), BIG, dtype=torch.float32, device=device)


def _set(validity: torch.Tensor, docids: torch.Tensor,
         value: float) -> torch.Tensor:
    docids = docids.to(validity.device, torch.int64)
    docids = docids[(docids >= 0) & (docids < validity.shape[0])]
    out = validity.clone()
    out[docids] = value
    return out


def mark_live(validity: torch.Tensor, docids: torch.Tensor) -> torch.Tensor:
    return _set(validity, docids, 0.0)


def mark_deleted(validity: torch.Tensor,
                 docids: torch.Tensor) -> torch.Tensor:
    return _set(validity, docids, BIG)


def range_penalty(col: torch.Tensor, lower, upper,
                  include_lower: bool = True,
                  include_upper: bool = True) -> torch.Tensor:
    """Penalty from one numeric range predicate over a device column.
    Bounds are rounded to f32 first, as the JAX package does."""
    c = col.float()
    lo = float(np.float32(lower))
    hi = float(np.float32(upper))
    ok_lo = c >= lo if include_lower else c > lo
    ok_hi = c <= hi if include_upper else c < hi
    return torch.where(ok_lo & ok_hi, 0.0, BIG).float()


def mask_penalty(mask_u8: torch.Tensor) -> torch.Tensor:
    """Boolean/u8 mask (term filters) → penalty."""
    return torch.where(mask_u8 > 0, 0.0, BIG).float()


def combine(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """AND-combine penalties (sum; saturates at BIG)."""
    out = parts[0]
    for p in parts[1:]:
        out = torch.clamp_max(out + p, BIG)
    return out
