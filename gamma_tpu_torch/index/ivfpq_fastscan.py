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
keeps the reference's layout.  The gather scan is
ops/ivf_scan.ivfpqfs_search; the dense scan and OPQ are IVFPQIndex's,
with a mirror row of decode(code) plus, when by_residual, the coarse
centroid.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from gamma_tpu_torch.config import SearchParams
from gamma_tpu_torch.index.ivfpq import IVFPQIndex
from gamma_tpu_torch.index.registry import register_model
from gamma_tpu_torch.ops import ivf_scan, kmeans as km, pq as pq_ops
from gamma_tpu_torch.ops.adc import unpack_nibbles
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
    packed_codes = True      # two 4-bit codes a byte

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

    def train(self, x, coarse=None) -> None:
        if self.by_residual:
            # residual 4-bit PQ trains exactly like 8-bit IVFPQ; `coarse`
            # seeds a shared coarse quantizer (see IVFPQIndex.train)
            super().train(x, coarse=coarse)
            return
        x0 = self._train_set(x)
        xd = x0
        if self.p.has_opq:
            self.opq_rot = self._train_opq_init(xd)
            xd = xd @ self.opq_rot
        self._fit_coarse(xd, coarse)
        self.pq = pq_ops.train_pq(self._pq_train_rows(xd),
                                  self.p.nsubvector, nbits=4, iters=12)
        if self.p.has_opq:
            # the codebooks end in the final rotated space; the coarse
            # quantizer is fit there again (ROADMAP.md C3)
            self._refine_opq_fs(xd)
            self._fit_coarse(self._rotate(x0), coarse)
        self._trained = True

    def _fit_coarse(self, xd: torch.Tensor, coarse=None) -> None:
        if coarse is not None:
            self._set_coarse(coarse)
            return
        cents, _ = km.kmeans(xd, self.p.ncentroids, iters=10, seed=0)
        self.centroids = cents
        self.cent_norms = l2_norms(cents)

    def _refine_opq_fs(self, x: torch.Tensor, iters: int = 4) -> None:
        """Procrustes OPQ refinement against the non-residual decode, as
        the JAX package runs it.  Each step rotates the already rotated
        `x` again, so the model keeps the product of the init rotation
        and every step's; the JAX package keeps the last step's alone
        (ROADMAP.md C3)."""
        total = self.opq_rot
        for _ in range(iters):
            codes = pq_ops.encode_pq(self.pq, x)
            recon = pq_ops.decode_pq(self.pq, codes)[:, :self.d]
            u, _, vt = torch.linalg.svd(x.T @ recon, full_matrices=False)
            rot = u @ vt
            x = x @ rot
            total = total @ rot
            self.pq = pq_ops.train_pq(x, self.p.nsubvector, nbits=4,
                                      iters=6)
        self.opq_rot = total

    # ---- ingest ----

    def _encode_core(self, xp: torch.Tensor):
        """Rotate (OPQ) → coarse assign → 4-bit PQ → pack nibbles, and the
        mirror rows.  → (assign [n] i64, codes [n, M/2] u8, recon [n, d],
        recon_norms [n] f32)."""
        xf = self._rotate(xp.float())
        assign = km.assign_nearest(xf, self.centroids, self.cent_norms)
        target = xf - self.centroids[assign] if self.by_residual else xf
        packed = pack_nibbles(pq_ops.encode_pq(self.pq, target))
        recon = self._recon_rows(assign, packed)
        return assign, packed, recon, l2_norms(recon)

    def _recon_rows(self, lists: torch.Tensor,
                    codes: torch.Tensor) -> torch.Tensor:
        """Mirror rows of packed posting codes: decode(unpack(code)), plus
        the coarse centroid when by_residual."""
        rec = pq_ops.decode_pq(self.pq, unpack_nibbles(codes))[:, :self.d]
        if self.by_residual:
            rec = rec + self.centroids[lists]
        return rec.to(self.recon_dtype)

    # ---- search ----

    def search(self, queries, penalty, sp: SearchParams, k: int,
               dist_range=None, validity_n=None):
        metric = self.metric_name(sp, self.p.metric_type)
        if not self._trained:
            return self._brute_fallback(queries, penalty, k, metric,
                                        dist_range)
        if self.scan_mode(sp) == "dense":
            return super().search(queries, penalty, sp, k, dist_range,
                                  validity_n=validity_n)
        nprobe = min(sp.nprobe or self.p.nprobe, self.p.ncentroids)
        fn = functools.partial(ivf_scan.ivfpqfs_search,
                               by_residual=self.by_residual)
        return self._gather_exec(fn, self._rotate(queries), queries,
                                 penalty, sp, k, max(sp.recall_num, k),
                                 metric, dist_range, nprobe, validity_n)
