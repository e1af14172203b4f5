"""Binary IVF: Hamming-distance retrieval over packed bit codes
(counterpart of gamma_tpu/index/binary_ivf.py).

Reference: index/impl/gamma_index_binary_ivf.{h,cc} — faiss IndexBinaryIVF
(vectors of dimension/8 bytes, Hamming metric) with realtime lists.

Input contract deviation (the JAX package's, kept): the reference ingests
pre-binarized uint8 vectors; this engine's ingest path carries float
vectors, so the model binarizes by sign (bit = x > 0) at train, add and
search time.  Users with native binary data pass ±1 floats and get exact
parity.  The Hamming scan (ops/ivf_scan.binary_ivf_search) is XOR and a
population count in plain torch ops: the JAX package runs it as XLA
code, with no Pallas kernel behind it.
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
from gamma_tpu_torch.utils.growth import grow_rows
from gamma_tpu_torch.vector.raw_store import RawVectorStore


def pack_bits_np(x: np.ndarray) -> np.ndarray:
    """float [n, d] → packed sign bits u8 [n, ceil(d/8)] (little-endian
    within a byte, matching np.packbits(bitorder='little'))."""
    bits = (np.asarray(x) > 0)
    return np.packbits(bits, axis=-1, bitorder="little")


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """pack_bits_np on the tensor's device: float [n, d] → u8 [n,
    ceil(d/8)], bit j of byte i = x[:, 8i + j] > 0."""
    n, d = x.shape
    bits = (x > 0).to(torch.int32)
    if d % 8:
        bits = torch.nn.functional.pad(bits, (0, 8 - d % 8))
    weights = 1 << torch.arange(8, dtype=torch.int32, device=x.device)
    return (bits.reshape(n, -1, 8) * weights).sum(-1).to(torch.uint8)


def _signs(x: torch.Tensor) -> torch.Tensor:
    """The ±1 lift of the sign bits (what k-means runs on)."""
    return torch.where(x > 0, 1.0, -1.0)


@register_model("BINARYIVF")
class BinaryIVFIndex(RetrievalModel):
    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(raw_store, params)
        p = dict(params or {})
        p.setdefault("ncentroids", 256)
        self.p = IVFPQParams.from_dict(p)
        self.d = raw_store.d
        self.device = raw_store.dev
        self.width = -(-self.d // 8)
        self._trained = False
        self.centroid_bits: Optional[torch.Tensor] = None   # [nlist, W] u8
        self._cent_f: Optional[torch.Tensor] = None   # float centroids
        self._cent_norms: Optional[torch.Tensor] = None
        init_cap = max(64, self.p.bucket_init_size)
        self.state = rt.init_state(self.p.ncentroids, init_cap, self.width,
                                   self.device)
        self.placer = rt.HostPlacer(self.p.ncentroids, init_cap)

    def trained(self) -> bool:
        return self._trained

    def _set_centroids(self, cents: torch.Tensor) -> None:
        self._cent_f = cents
        self._cent_norms = l2_norms(cents)
        self.centroid_bits = pack_bits(cents)

    def train(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        hi = self.p.ncentroids * TRAIN_MAX_PER_LIST
        if x.shape[0] > hi:
            x = x[np.random.default_rng(0).choice(x.shape[0], hi,
                                                  replace=False)]
        # k-means in sign space: cluster the ±1 lift of the bits so the
        # centroids binarize faithfully (the reference trains k-means on
        # the binary vectors' float lift inside faiss)
        signs = _signs(torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device))
        cents, _ = km.kmeans(signs, self.p.ncentroids, iters=10)
        self._set_centroids(cents)
        self._trained = True

    def add(self, x, vids: np.ndarray, docids: np.ndarray) -> None:
        assert self._trained, "BINARYIVF.add before train"
        if x.shape[0] == 0:
            return
        if torch.is_tensor(x):
            xd = x.to(self.device).float()
        else:
            xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
                self.device)
        assign = km.assign_nearest(_signs(xd), self._cent_f,
                                   self._cent_norms)
        codes = pack_bits(xd)
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
        self._publish(state=state)
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
            self._publish(state=rt.tombstone(
                self.state, torch.from_numpy(ls[live]).to(self.device),
                torch.from_numpy(ps[live]).to(self.device)))
            self.placer.mark_deleted(vids[live])

    def compact(self, threshold: float = 0.3) -> None:
        """Reclaim tombstoned slots when >= 30% are dead (reference
        policy: realtime_mem_data.cc:373-377; the JAX package's binary
        IVF keeps its tombstones)."""
        if self.placer.deleted_fraction() < threshold:
            return
        state = rt.compact_state(self.state)
        self._publish(state=state)
        self.placer.resync_after_compact(state.docids.cpu().numpy(),
                                         state.vids.cpu().numpy(),
                                         state.lens.cpu().numpy())

    def search(self, queries, penalty, sp: SearchParams, k: int,
               dist_range=None, validity_n=None):
        """Hamming distances live in their own score space: a score range
        stays a post-filter (the engine's), as in the JAX package."""
        assert self._trained, "BINARYIVF requires training before search"
        qbits = pack_bits(queries.float())
        nprobe = min(sp.nprobe or max(1, self.p.ncentroids // 16),
                     self.p.ncentroids)
        (state,) = self._read("state")
        return ivf_scan.binary_ivf_search(state, self.centroid_bits, qbits,
                                          penalty, nprobe=nprobe, k=k)

    # ---- persistence (the JAX package's <field>.bivf.npz format) ----

    def _dump_file(self, path: str) -> str:
        return os.path.join(path, f"{self.store.name}.bivf.npz")

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(self._dump_file(path), **convert.bivf_torch_to_arrays(self))

    def load(self, path: str) -> int:
        f = self._dump_file(path)
        if not os.path.exists(f):
            return 0
        with np.load(f) as z:
            st = convert.bivf_arrays_to_torch(z, self.device)
        if not st["trained"]:
            return 0
        self._set_centroids(st["cent_f"])
        state = st["state"]
        self.placer = rt.HostPlacer(state.nlist, state.cap)
        self.placer.resync_after_compact(state.docids.cpu().numpy(),
                                         state.vids.cpu().numpy(),
                                         state.lens.cpu().numpy())
        self._publish(state=state)
        self.indexed_count = st["indexed_count"]
        self._trained = True
        return self.indexed_count

    def mem_bytes(self) -> int:
        m = self.state.mem_bytes()
        if self._cent_f is not None:
            m += self._cent_f.numel() * 4 + self.centroid_bits.numel()
        return int(m)
