"""IVFPQ FastScan — 4-bit PQ with packed codes (counterpart of
gamma_tpu/index/ivfpq_fastscan.py).

Reference: index/impl/gamma_index_ivfpqfs.{h,cc} — faiss
IndexIVFPQFastScan under the gamma realtime layer.  Capability contract
kept:
  * nbits_per_idx is forced to 4 (ivfpqfs.cc:209 "only support 4 now");
  * codes are packed two per byte, subquantizer 2j in the low nibble of
    byte j and 2j+1 in the high nibble — the posting payload is M/2
    bytes;
  * the same realtime add/update/delete/compact + dump/load surface
    (`<field>.ivfpqfs.npz`, the JAX package's format).

by_residual defaults to True (the JAX package's deviation from the
reference's forced by_residual=false, ivfpqfs.cc:146): the grouped ADC
kernel (B3, packed form) builds the per-(query, probed-list) residual
LUT in-kernel, so residual coding costs nothing.  {"by_residual": false}
keeps the reference's layout.  The scan is ops/ivf_scan.ivfpqfs_search;
the model holds no reconstruction mirror (gather tier only).  OPQ
raises NotImplementedError (ROADMAP.md A.2).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from gamma_tpu_torch.config import SearchParams
from gamma_tpu_torch.index.ivfpq import IVFPQIndex
from gamma_tpu_torch.index.registry import register_model
from gamma_tpu_torch.ops import ivf_scan, kmeans as km, pq as pq_ops
from gamma_tpu_torch.ops.distances import l2_norms
from gamma_tpu_torch.vector.raw_store import RawVectorStore


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """[n, M] codes in 0..15 → [n, M/2] u8, subquantizer 2j in the low
    nibble of byte j and 2j+1 in the high nibble."""
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).to(torch.uint8)


@register_model("IVFPQ_FASTSCAN")
class IVFPQFastScanIndex(IVFPQIndex):
    _dump_suffix = "ivfpqfs"
    # the packed 4-bit codes ARE this model's gather payload
    _sq_payload_default = "pq"

    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        p = dict(params or {})
        # the reference forces 4-bit codes (ivfpqfs.cc:209) and defaults M
        # to a finer split than 8-bit PQ
        p["nbits_per_idx"] = 4
        p.setdefault("nsubvector", 64)
        if int(p["nsubvector"]) % 2:
            raise ValueError("IVFPQ_FASTSCAN requires even nsubvector "
                             "(codes pack two 4-bit entries per byte)")
        self.by_residual = bool(p.get("by_residual", True))
        super().__init__(raw_store, p)

    def _code_width(self) -> int:
        return self.p.nsubvector // 2

    # ---- training: by_residual=False codes the raw vector ----

    def train(self, x: np.ndarray) -> None:
        if self.by_residual:
            # residual 4-bit PQ trains exactly like 8-bit IVFPQ
            super().train(x)
            return
        xd = torch.from_numpy(np.ascontiguousarray(
            self.clamp_train_set(np.asarray(x, np.float32)))).to(self.device)
        cents, _ = km.kmeans(xd, self.p.ncentroids, iters=10, seed=0)
        self.centroids = cents
        self.cent_norms = l2_norms(cents)
        self.pq = pq_ops.train_pq(self._pq_train_rows(xd),
                                  self.p.nsubvector, nbits=4, iters=12)
        self._trained = True

    # ---- ingest ----

    def _encode_core(self, xp: torch.Tensor):
        """Coarse assignment + packed 4-bit codes of a padded batch.
        → (assign [n] i64, codes [n, M/2] u8)."""
        xf = xp.float()
        assign = km.assign_nearest(xf, self.centroids, self.cent_norms)
        target = xf - self.centroids[assign] if self.by_residual else xf
        return assign, pack_nibbles(pq_ops.encode_pq(self.pq, target))

    # ---- search ----

    def search(self, queries, penalty, sp: SearchParams, k: int,
               dist_range=None, validity_n=None):
        metric = self.metric_name(sp, self.p.metric_type)
        if not self._trained:
            return self._brute_fallback(queries, penalty, k, metric,
                                        dist_range)
        self.scan_mode(sp)
        nprobe = min(sp.nprobe or self.p.nprobe, self.p.ncentroids)
        fn = functools.partial(ivf_scan.ivfpqfs_search,
                               by_residual=self.by_residual)
        return self._gather_exec(fn, queries, penalty, sp, k,
                                 max(sp.recall_num, k), metric, dist_range,
                                 nprobe, validity_n)
