"""ScaNN-style index, the reference's VEARCH retrieval type (counterpart
of gamma_tpu/index/scann.py).

Reference: index/impl/scann/ — the reference links Google's ScaNN engine
(index/impl/scann/scann_api.h) as retrieval types VEARCH / SCANN.  Its
distinguishing technique is score-aware anisotropic quantization
(ops/avq.py); partitioning, the asymmetric-hash scan and the exact
rerank are the IVF-ADC pipeline of IVFPQ, so this model is IVFPQ with:
  * anisotropic codebook training on residuals, the directions taken
    from the original (rotated) datapoints (train_avq);
  * anisotropic assignment at encode time (encode_avq);
  * inner product by default (ScaNN targets MIPS);
  * the PQ codes as the gather payload.

Training takes the JAX package's order: the OPQ init rotation alone (no
refinement), then the coarse k-means, the residuals and train_avq — so
the port's OPQ deviation of IVFPQ (ROADMAP.md C3) does not enter here.
Search is inherited unchanged: dense over the reconstruction mirror, or
gather through B3 (csrc/gadc.cu) with the inner-product table (alpha 1,
no codebook norms) and the exact rerank's rows fetched by X1.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from gamma_tpu_torch.index.ivfpq import IVFPQIndex
from gamma_tpu_torch.index.registry import register_model
from gamma_tpu_torch.ops import avq, kmeans as km
from gamma_tpu_torch.ops.distances import l2_norms
from gamma_tpu_torch.vector.raw_store import RawVectorStore


@register_model("VEARCH")
@register_model("SCANN")
class ScaNNIndex(IVFPQIndex):
    _dump_suffix = "scann"
    # anisotropic codes are the model's point; keep the ADC gather path
    _sq_payload_default = "pq"

    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        p = dict(params or {})
        p.setdefault("metric_type", "InnerProduct")   # ScaNN targets MIPS
        super().__init__(raw_store, p)
        t = float(p.get("anisotropic_threshold", 0.2))
        self.eta = float(p.get("eta", avq.eta_from_threshold(t, self.d)))

    # ---- training: anisotropic codebooks ----

    def train(self, x: np.ndarray) -> None:
        xd = torch.from_numpy(np.ascontiguousarray(
            self.clamp_train_set(np.asarray(x, np.float32)))).to(self.device)
        if self.p.has_opq:
            self.opq_rot = self._train_opq_init(xd)
            xd = xd @ self.opq_rot
        self.centroids, _ = km.kmeans(xd, self.p.ncentroids, iters=10,
                                      seed=0)
        self.cent_norms = l2_norms(self.centroids)
        assign = km.assign_nearest(xd, self.centroids, self.cent_norms)
        residuals = xd - self.centroids[assign]
        self.pq = avq.train_avq(residuals, self.p.nsubvector, dirs=xd,
                                nbits=self.p.nbits_per_idx, eta=self.eta,
                                iters=8)
        self._trained = True

    # ---- ingest: anisotropic assignment ----

    def _encode_core(self, xp: torch.Tensor):
        """Rotate (OPQ) → coarse assign → residual → ANISOTROPIC encode
        (directions = the rotated datapoints) → mirror rows.
        → (assign [n] i64, codes [n, M] u8, recon [n, d], recon_norms
        [n] f32)."""
        xf = self._rotate(xp.float())
        assign = km.assign_nearest(xf, self.centroids, self.cent_norms)
        codes = avq.encode_avq(self.pq, xf - self.centroids[assign], xf,
                               M=self.pq.M, eta=self.eta)
        recon = self._recon_rows(assign, codes)
        return assign, codes, recon, l2_norms(recon)
