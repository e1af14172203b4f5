"""Query grouping for the grouped posting-list scans (counterpart of the
helpers in gamma_tpu/ops/pallas_gadc.py).

The grouped kernels invert the (query, probe) → list mapping: queries
probing the same inverted list form a group of at most q_pad slots, so
one pass over a list's codes serves every query in the group.  The
grouped ADC kernel that also lives in pallas_gadc.py is ported later;
ops/gsq.py uses these helpers today.
"""

from __future__ import annotations

import torch


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def default_q_pad(b: int, p: int, nlist: int) -> int:
    """Query slots per group: ~2x the mean list occupancy of the batch,
    clamped to [8, 128]."""
    mean = max(1, (b * p) // max(1, nlist))
    q = 8
    while q < 2 * mean and q < 128:
        q *= 2
    return q


def group_bound(b: int, p: int, nlist: int, q_pad: int) -> int:
    """Static bound on the number of (list, chunk) groups: at most one
    group per occupied list plus one extra chunk per q_pad pairs."""
    bp = b * p
    return _round_up(min(nlist, bp) + _cdiv(bp, q_pad) + 1, 8)


def build_groups(list_ids: torch.Tensor,    # [B, P] int
                 lens: torch.Tensor,        # [nlist] int
                 *, q_pad: int, tile: int, g_pad: int):
    """Group the B·P (query, probe) pairs by list, q_pad pairs per group
    (lists probed by more get extra chunk groups).  One stable sort plus
    cumulative scans, all on the device.

    → (glist [g_pad] i32     — list id per group (0 for inactive),
       ntiles [g_pad] i32    — live `tile`-slot tiles per group (0 → skip),
       gpair [g_pad, q_pad]  — flat pair index per slot (-1 pad), i64,
       pair_gid [B·P] i64,
       pair_slot [B·P] i64)  — inverse map for ungrouping."""
    dev = list_ids.device
    bp = list_ids.numel()
    li = list_ids.reshape(-1).long()
    order = torch.argsort(li, stable=True)
    sl = li[order]
    idx = torch.arange(bp, device=dev)
    is_start = torch.ones(bp, dtype=torch.bool, device=dev)
    is_start[1:] = sl[1:] != sl[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    slot = (idx - run_start) % q_pad
    gid = torch.cumsum((is_start | (slot == 0)).long(), dim=0) - 1
    keep = gid < g_pad
    glist = torch.zeros(g_pad, dtype=torch.int64, device=dev)
    glist[gid[keep]] = sl[keep]
    gpair = torch.full((g_pad, q_pad), -1, dtype=torch.int64, device=dev)
    gpair[gid[keep], slot[keep]] = order[keep]
    pair_gid = torch.empty_like(gid)
    pair_gid[order] = gid
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot
    active = torch.arange(g_pad, device=dev) < gid[-1] + 1
    glens = lens.long()[glist]
    ntiles = torch.where(active, (glens + tile - 1) // tile, 0)
    return (glist.int(), ntiles.int(), gpair, pair_gid, pair_slot)
