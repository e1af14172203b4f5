"""IVFFlat: IVF cells with full vectors as the posting payload
(counterpart of gamma_tpu/index/ivfflat.py).

Reference: index/impl/gamma_index_ivfflat.{h,cc} — faiss IndexIVFFlat with
realtime lists; the scanner computes exact L2/IP per posting
(ivfflat.h:31-77).  Here the payload is bf16 vector bytes stored in the
same IVFState container; the scan views them as bf16 rows again and
computes exact distances to them (ops/ivf_scan.ivfflat_search): grouped,
through the B1 kernel's bf16-row form (csrc/gsq.cu), on any device — the
JAX package's TPU dispatch — or per query over gathered lists when the
model is created with {"scan_impl": "gather"}.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from gamma_tpu_torch import convert
from gamma_tpu_torch.config import IVFPQParams, SearchParams
from gamma_tpu_torch.index.ivfpq import TRAIN_MAX_PER_LIST, _place_batch
from gamma_tpu_torch.index.model import RetrievalModel
from gamma_tpu_torch.index.registry import register_model
from gamma_tpu_torch.ops import ivf_scan, kmeans as km
from gamma_tpu_torch.ops.distances import l2_norms
from gamma_tpu_torch.realtime import invert_index as rt
from gamma_tpu_torch.utils.growth import grow_rows, ladder_256
from gamma_tpu_torch.vector.raw_store import RawVectorStore


def _to_bf16_bytes(x: torch.Tensor) -> torch.Tensor:
    """[n, d] → the bytes of its bf16 rounding, [n, 2d] u8."""
    return x.to(torch.bfloat16).contiguous().view(torch.uint8)


@register_model("IVFFLAT")
class IVFFlatIndex(RetrievalModel):
    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(raw_store, params)
        p = dict(params or {})
        p.setdefault("ncentroids", 256)   # reference default for ivfflat
        self.scan_impl = str(p.pop("scan_impl", "grouped"))
        self.p = IVFPQParams.from_dict(p)
        self.d = raw_store.d
        self.device = raw_store.dev
        self._trained = False
        self.centroids: Optional[torch.Tensor] = None
        self.cent_norms: Optional[torch.Tensor] = None
        init_cap = max(64, self.p.bucket_init_size)
        # zero-filled (as every growth of it): the grouped scan wants
        # the rows of dead slots finite
        self.state = rt.init_state(self.p.ncentroids, init_cap, self.d * 2,
                                   self.device)
        self.placer = rt.HostPlacer(self.p.ncentroids, init_cap)
        self._max_len = 0          # live list-length watermark (host)

    def trained(self) -> bool:
        return self._trained

    def train(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        hi = self.p.ncentroids * TRAIN_MAX_PER_LIST
        if x.shape[0] > hi:
            x = x[np.random.default_rng(0).choice(x.shape[0], hi,
                                                  replace=False)]
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        cents, _ = km.kmeans(xd, self.p.ncentroids, iters=10)
        self.centroids = cents
        self.cent_norms = l2_norms(cents)
        self._trained = True

    def add(self, x, vids: np.ndarray, docids: np.ndarray) -> None:
        assert self._trained
        if x.shape[0] == 0:
            return
        if torch.is_tensor(x):
            xd = x.to(self.device).float()
        else:
            xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
                self.device)
        assign = km.assign_nearest(xd, self.centroids, self.cent_norms)
        codes = _to_bf16_bytes(xd)
        ids = torch.from_numpy(np.stack([
            np.asarray(vids, np.int64), np.asarray(docids, np.int64)])).to(
                self.device)
        state = self.state
        # slots against the live device lens (the IVFPQ model's placement)
        positions, new_lens, need_d = _place_batch(
            state.lens, assign, ids[0], nlist=self.p.ncentroids)
        need = int(need_d)
        if need > state.cap:
            new_cap = grow_rows(state.cap, need, quantum=1024)
            state = rt.grow(state, new_cap)
            self.placer.cap = new_cap
        state = rt.append(state, assign, positions, codes, ids[0], ids[1],
                          new_lens)
        self.placer.register(assign.cpu().numpy(), positions.cpu().numpy(),
                             np.asarray(vids, np.int64))
        # the state and the watermark its scan width comes from, as one
        self._publish(state=state, _max_len=max(self._max_len, need))
        # watermark = highest vid pumped + 1; update re-adds of old vids
        # must not inflate it past fresh rows (pump skips them otherwise)
        self.indexed_count = max(self.indexed_count, int(np.max(vids)) + 1)

    def delete(self, vids: np.ndarray) -> None:
        vids = np.asarray(vids, np.int64)
        if vids.size == 0:
            return
        ls, ps = self.placer.locate(vids)
        live = ls >= 0
        if live.any():
            self.state = rt.tombstone(
                self.state, torch.from_numpy(ls[live]).to(self.device),
                torch.from_numpy(ps[live]).to(self.device))
            self.placer.mark_deleted(vids[live])

    def compact(self, threshold: float = 0.3) -> None:
        if self.placer.deleted_fraction() < threshold:
            return
        state = rt.compact_state(self.state)
        lens_np = state.lens.cpu().numpy()
        self._publish(state=state, _max_len=int(lens_np.max(initial=0)))
        self.placer.resync_after_compact(state.docids.cpu().numpy(),
                                         state.vids.cpu().numpy(), lens_np)

    def _cap_eff(self) -> int:
        """Scan width: the ladder step covering the live watermark."""
        return ladder_256(max(self._max_len, 1), self.state.cap)

    def search(self, queries, penalty, sp: SearchParams, k: int,
               dist_range=None, validity_n=None):
        metric = self.metric_name(sp, self.p.metric_type)
        if not self._trained:
            return self._brute_fallback(queries, penalty, k, metric,
                                        dist_range)
        nprobe = min(sp.nprobe or max(1, self.p.ncentroids // 16),
                     self.p.ncentroids)
        state, max_len = self._read("state", "_max_len")
        return ivf_scan.ivfflat_search(
            state, self.centroids, self.cent_norms, queries, penalty,
            dist_range, nprobe=nprobe, k=k, d=self.d, metric=metric,
            scan_impl=self.scan_impl,
            cap_eff=ladder_256(max(max_len, 1), state.cap))

    # ---- persistence (the JAX package's <field>.ivfflat.npz format) ----

    def _dump_file(self, path: str) -> str:
        return os.path.join(path, f"{self.store.name}.ivfflat.npz")

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(self._dump_file(path),
                 **convert.ivfflat_torch_to_arrays(self))

    def load(self, path: str) -> int:
        f = self._dump_file(path)
        if not os.path.exists(f):
            return 0
        with np.load(f) as z:
            st = convert.ivfflat_arrays_to_torch(z, self.device)
        if not st["trained"]:
            return 0
        self.centroids, self.cent_norms = st["centroids"], st["cent_norms"]
        state = st["state"]
        lens = state.lens.cpu().numpy()
        self.placer = rt.HostPlacer(state.nlist, state.cap)
        self.placer.resync_after_compact(state.docids.cpu().numpy(),
                                         state.vids.cpu().numpy(), lens)
        self._publish(state=state, _max_len=int(lens.max(initial=0)))
        self.indexed_count = st["indexed_count"]
        self._trained = True
        return self.indexed_count

    def mem_bytes(self) -> int:
        m = self.state.mem_bytes()
        if self.centroids is not None:
            m += self.centroids.numel() * 4
        return int(m)
