"""Real-time inverted lists as padded dense device tensors (counterpart of
gamma_tpu/realtime/invert_index.py).

  codes[nlist, cap, W] u8, vids/docids[nlist, cap] i32 (-1 = empty or
  tombstone), lens[nlist] i32 = the published lengths.

Publishing is copy-on-write: every update returns a NEW IVFState built
from clones, and the owner swaps its reference.  A search that already
holds the previous state keeps reading consistent tensors (the analog
of the reference's delayed frees; in-place updates are a later
decision).  Scatter rows whose (list, pos) falls outside the state —
the -1 padding of a batch — are dropped by a boolean mask, never written.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class IVFState(NamedTuple):
    """One shard of inverted lists; the scan op interprets the bytes."""

    codes: torch.Tensor     # [nlist, cap, code_width] u8
    vids: torch.Tensor      # [nlist, cap] i32  (-1 = empty/tombstone)
    docids: torch.Tensor    # [nlist, cap] i32  (-1 = empty/tombstone)
    lens: torch.Tensor      # [nlist] i32 — published lengths

    @property
    def nlist(self) -> int:
        return self.codes.shape[0]

    @property
    def cap(self) -> int:
        return self.codes.shape[1]

    @property
    def code_width(self) -> int:
        return self.codes.shape[2]

    def mem_bytes(self) -> int:
        return (self.codes.numel() + self.vids.numel() * 4
                + self.docids.numel() * 4 + self.lens.numel() * 4)


def init_state(nlist: int, cap: int, code_width: int,
               device=None) -> IVFState:
    return IVFState(
        codes=torch.zeros((nlist, cap, code_width), dtype=torch.uint8,
                          device=device),
        vids=torch.full((nlist, cap), -1, dtype=torch.int32, device=device),
        docids=torch.full((nlist, cap), -1, dtype=torch.int32,
                          device=device),
        lens=torch.zeros((nlist,), dtype=torch.int32, device=device),
    )


def in_bounds(list_ids: torch.Tensor, positions: torch.Tensor,
              nlist: int, cap: int) -> torch.Tensor:
    """Rows whose (list, pos) slot exists — padding (-1) and overflow
    rows are dropped by the scatters."""
    return ((list_ids >= 0) & (list_ids < nlist)
            & (positions >= 0) & (positions < cap))


def append(state: IVFState, list_ids: torch.Tensor, positions: torch.Tensor,
           codes: torch.Tensor, vids: torch.Tensor, docids: torch.Tensor,
           new_lens: torch.Tensor) -> IVFState:
    """Scatter a batch at pre-assigned (list, pos) slots and publish the
    new lens.  Rows with list_id or position -1 are dropped."""
    m = in_bounds(list_ids, positions, state.nlist, state.cap)
    li, pos = list_ids[m].long(), positions[m].long()
    out_codes = state.codes.clone()
    out_vids = state.vids.clone()
    out_docids = state.docids.clone()
    out_codes[li, pos] = codes[m]
    out_vids[li, pos] = vids[m].int()
    out_docids[li, pos] = docids[m].int()
    return IVFState(out_codes, out_vids, out_docids, new_lens.int())


def tombstone(state: IVFState, list_ids: torch.Tensor,
              positions: torch.Tensor) -> IVFState:
    """Mark entries dead (update/delete path).  Scans mask docid < 0;
    lens are unchanged — the slot is reclaimed at compaction."""
    m = in_bounds(list_ids, positions, state.nlist, state.cap)
    li, pos = list_ids[m].long(), positions[m].long()
    vids = state.vids.clone()
    docids = state.docids.clone()
    vids[li, pos] = -1
    docids[li, pos] = -1
    return state._replace(vids=vids, docids=docids)


def grow(state: IVFState, new_cap: int) -> IVFState:
    """Capacity reallocation (analog of ExtendBucketMem)."""
    assert new_cap > state.cap
    pad = new_cap - state.cap
    f = torch.nn.functional.pad
    return IVFState(
        codes=f(state.codes, (0, 0, 0, pad)),
        vids=f(state.vids, (0, pad), value=-1),
        docids=f(state.docids, (0, pad), value=-1),
        lens=state.lens,
    )


def _compact_order(state: IVFState):
    """Per-list stable order putting live entries first."""
    cap = state.cap
    pos = torch.arange(cap, device=state.vids.device)[None, :]
    live = (state.docids >= 0) & (pos < state.lens[:, None])
    order = torch.argsort(torch.where(live, pos, cap + pos), dim=1,
                          stable=True)
    return order, torch.gather(live, 1, order)


def compact_state_with(state: IVFState, extras: Tuple[torch.Tensor, ...]
                       ) -> Tuple[IVFState, Tuple[torch.Tensor, ...]]:
    """Stable-partition every list so live entries are dense (analog of
    CompactBucket, realtime_mem_data.cc:119-150), permuting sidecar
    arrays [nlist, cap_e, ...] by the same per-list order.  An extra may
    be narrower than the posting cap: every live slot sits below its
    width, so the order prefix covers them and dead tail entries clamp
    to garbage that scans mask."""
    order, live = _compact_order(state)
    w = state.code_width
    codes = torch.gather(state.codes, 1,
                         order[:, :, None].expand(-1, -1, w))
    vids = torch.where(live, torch.gather(state.vids, 1, order), -1)
    docids = torch.where(live, torch.gather(state.docids, 1, order), -1)
    lens = live.sum(1).int()
    out = []
    for e in extras:
        ew = e.shape[1]
        o = order[:, :ew].clamp(0, ew - 1)
        if e.dim() == 3:
            o = o[:, :, None].expand(-1, -1, e.shape[2])
        out.append(torch.gather(e, 1, o))
    return IVFState(codes, vids.int(), docids.int(), lens), tuple(out)


def compact_state(state: IVFState) -> IVFState:
    """compact_state_with for a state without sidecars."""
    return compact_state_with(state, ())[0]


# ----------------------------------------------------------------------
# Host-side placement map (single-writer control plane)
# ----------------------------------------------------------------------

class HostPlacer:
    """Mirrors lens in numpy and keeps the vid→(list, pos) map (analog
    of vid_bucket_no_pos_, realtime_mem_data.h global vid map).
    Placement itself runs on the device (IVFPQIndex._place_batch) and is
    registered here lazily."""

    def __init__(self, nlist: int, cap: int):
        self.nlist = nlist
        self.cap = cap
        self.lens = np.zeros(nlist, dtype=np.int32)
        self.deleted = np.zeros(nlist, dtype=np.int32)   # per-list tombstones
        self._vid_list = np.full(1024, -1, dtype=np.int32)
        self._vid_pos = np.full(1024, -1, dtype=np.int32)

    def _ensure_vid(self, max_vid: int) -> None:
        if max_vid >= self._vid_list.size:
            new = max(max_vid + 1, self._vid_list.size * 2)
            for name in ("_vid_list", "_vid_pos"):
                old = getattr(self, name)
                arr = np.full(new, -1, dtype=np.int32)
                arr[: old.size] = old
                setattr(self, name, arr)

    def register(self, list_ids: np.ndarray, positions: np.ndarray,
                 vids: np.ndarray) -> None:
        """Record placements computed on the device: update lens and the
        vid map.  Batches must be registered in add order."""
        list_ids = np.asarray(list_ids, dtype=np.int32)
        vids = np.asarray(vids, dtype=np.int64)
        np.add.at(self.lens, list_ids, 1)
        if vids.size:
            self._ensure_vid(int(vids.max()))
            self._vid_list[vids] = list_ids
            self._vid_pos[vids] = np.asarray(positions, dtype=np.int32)

    def locate(self, vids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        vids = np.asarray(vids, dtype=np.int64)
        self._ensure_vid(int(vids.max(initial=0)))
        return self._vid_list[vids].copy(), self._vid_pos[vids].copy()

    def mark_deleted(self, vids: np.ndarray) -> None:
        ls, _ = self.locate(vids)
        ls = ls[ls >= 0]
        if ls.size:
            np.add.at(self.deleted, ls, 1)

    def deleted_fraction(self) -> float:
        total = int(self.lens.sum())
        if total == 0:
            return 0.0
        return float(self.deleted.sum()) / total

    def resync_after_compact(self, docids_np: np.ndarray,
                             vids_np: np.ndarray,
                             lens_np: np.ndarray) -> None:
        """Rebuild the vid map from the posting arrays (after compaction
        or a load)."""
        self.lens = lens_np.astype(np.int32).copy()
        self.deleted[:] = 0
        self._vid_list[:] = -1
        self._vid_pos[:] = -1
        live = vids_np >= 0
        ls, ps = np.nonzero(live)
        vv = vids_np[ls, ps]
        self._ensure_vid(int(vv.max(initial=0)))
        self._vid_list[vv] = ls.astype(np.int32)
        self._vid_pos[vv] = ps.astype(np.int32)
