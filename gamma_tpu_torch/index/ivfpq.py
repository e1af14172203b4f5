"""IVFPQ — the flagship model (counterpart of gamma_tpu/index/ivfpq.py).

Reference: index/impl/gamma_index_ivfpq.{h,cc}.  Capability contract kept:
  * coarse quantizer over ncentroids cells         (Init .cc:119-214)
  * PQ codes over residuals, nsubvector x nbits    (Add .cc:424-512)
  * train-set clamp to nlist*256 rows              (.cc:281-296)
  * realtime posting lists w/ tombstone updates    (RTInvertIndex)
  * optional OPQ rotation (has_opq)
  * brute-force fallback when untrained            (.cc:529-537)

Two scan modes, resolved by the JAX package's rule (`scan_mode`):
  * "dense" (the default while the reconstruction mirror fits
    DENSE_BYTES_BUDGET): one product of the queries with a bf16 mirror
    of every row's PQ reconstruction, a top-recall_num select and an
    exact rerank of the candidates (ops/dense_scan.py, rows fetched by
    X1 of csrc/gather_rows.cu); nprobe does not apply;
  * "gather": the IVF scan of the probed lists over the payload
    `gather_payload` names —
      - "sq8" (the default): the residual-SQ8 sidecar, slot-aligned with
        the posting lists (ops/ivf_scan.ivfsq_search → B1/B2 of
        csrc/gsq.cu); past SQ_BYTES_BUDGET the sidecar is dropped and
        the model falls back to the PQ scan;
      - "pq": the M-byte PQ codes alone, scanned by ADC
        (ops/ivf_scan.ivfpq_search → B3 of csrc/gadc.cu, or B4 of
        csrc/adc.cu when M*ksub % 128 != 0) with an exact rerank of the
        top recall_num against the store mirror (X1 again).
The mirror is kept in gather mode too, as in the JAX package, until
`release_recon()` drops it.  On the disk tier (store_type "Disk" /
"RocksDB") neither the model nor the store holds a mirror: the scan is
gather only, and the PQ scan's exact rerank reads its candidates' rows
from the host through the store's row-block LRU (`_gather_exec`).
"""

from __future__ import annotations

import logging
import os
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from gamma_tpu_torch import convert
from gamma_tpu_torch.config import IVFPQParams, SearchParams
from gamma_tpu_torch.index.model import RetrievalModel
from gamma_tpu_torch.index.registry import register_model
from gamma_tpu_torch.ops import ivf_scan, kmeans as km, pq as pq_ops
from gamma_tpu_torch.ops.dense_scan import (dense_scan_search,
                                            dense_scan_search_fast)
from gamma_tpu_torch.ops.distances import BIG, l2_norms
from gamma_tpu_torch.ops.gsq import encode_sq, train_sq
from gamma_tpu_torch.realtime import invert_index as rt
from gamma_tpu_torch.utils.growth import grow_rows, ladder_256
from gamma_tpu_torch.vector.raw_store import RawVectorStore

TRAIN_MAX_PER_LIST = 256    # faiss/gamma clamp (ivfpq.cc:281-296)
# PQ/SQ codebook training subsample (the coarse quantizer still sees
# the full clamped train set)
PQ_TRAIN_MAX_ROWS = 131072
# the SQ8 sidecar's [nlist, cap, d_pad + 4] bytes must stay under this
# (sized for one 80 GB card); beyond it the sidecar is dropped and the
# gather tier falls back to the PQ ADC scan
SQ_BYTES_BUDGET = 32 << 30
RECON_ROW_PAD = 8192        # reconstruction-mirror growth quantum
# scan_mode "auto" resolves to dense while the mirror (bf16 rows + f32
# norms + f32 validity) stays under this.  Sized for one 80 GB card: at
# d 128 the mirror takes 268 B a row, and beside it the card holds the
# store mirror (~260 B a row), the posting state (M + 8 B a slot with
# growth slack) and the SQ8 sidecar (d_pad + 4 B a slot), ~3x the mirror
# in all, plus a copy-on-write copy of the mirror while an ingest batch
# commits and the dense scan's score tiles (DENSE_TILE_BYTES, 1 GB):
# 16 GB (~64M rows at d 128) keeps that sum under ~70 GB
DENSE_BYTES_BUDGET = 16 << 30


# what a search reads of the model's mutable state, taken as ONE snapshot
# (RetrievalModel._read) so that it never pairs tensors of two publishes
_SEARCHED = ("state", "sq_codes", "sq_norms", "_max_len", "keep_recon",
             "recon", "recon_norms", "recon_valid", "recon_bias")


def _pad_quantum(n: int) -> int:
    """Pad add-batches to a small set of shapes."""
    q = 1024
    while q < n and q < 65536:
        q *= 2
    return -(-n // q) * q


def _place_batch(lens: torch.Tensor, assign: torch.Tensor,
                 vids: torch.Tensor, *, nlist: int):
    """Device-side slot placement (the reference's atomic
    retrieve_idx_pos_ cursor bump, realtime_mem_data.cc:279-302): sort
    the batch by list, rank within equal-list runs, offset by the
    CURRENT device lens.  Padding rows (vids < 0) go to list `nlist`
    (dropped by the scatters) and do not count toward lens.
    → (positions [n] i64, new_lens [nlist] i32, need scalar tensor)."""
    n = assign.shape[0]
    li = torch.where(vids < 0, nlist, assign).long()
    lens_ext = torch.cat([lens.long(), lens.new_zeros(1).long()])
    order = torch.argsort(li, stable=True)
    sl = li[order]
    idx = torch.arange(n, device=li.device)
    is_start = torch.ones(n, dtype=torch.bool, device=li.device)
    is_start[1:] = sl[1:] != sl[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    positions = torch.empty_like(li)
    positions[order] = lens_ext[sl] + idx - run_start
    new_lens = (lens.long() + torch.bincount(li, minlength=nlist + 1)[:nlist])
    return positions, new_lens.int(), new_lens.max()


def _sq_encode_batch(xp, rot, cents, assign, scale, off, *, d_pad: int):
    """Residual-SQ8 encode of an ingest batch: rotate (OPQ) → take the
    coarse rows of its assignment → quantize the residual.
    → (codes [n, d_pad] u8, norms [n] f32)."""
    xf = xp.float()
    if rot is not None:
        xf = xf @ rot
    return encode_sq(xf, scale, off, cents[assign], d_pad=d_pad,
                     residual=True)


def _set_rows(dst: torch.Tensor, vids: torch.Tensor, src) -> torch.Tensor:
    """A copy of `dst` with dst[vids] = src; vids outside the rows (the
    -1 padding of a batch) are masked out before the write, since an
    out-of-range index on a CUDA tensor is a device-side assert."""
    m = (vids >= 0) & (vids < dst.shape[0])
    out = dst.clone()
    out[vids[m].long()] = src[m] if torch.is_tensor(src) else src
    return out


def _sq_append(sq_codes, sq_norms, assign, positions, vids, codes, norms):
    """Scatter a placed batch into the SQ8 sidecar at the same (list,
    pos) slots as the posting append (copy-on-write; padding rows and
    slots past the sidecar width are dropped)."""
    li = torch.where(vids < 0, -1, assign)
    m = rt.in_bounds(li, positions, sq_codes.shape[0], sq_codes.shape[1])
    li, pos = li[m], positions[m]
    out_c, out_n = sq_codes.clone(), sq_norms.clone()
    out_c[li, pos] = codes[m]
    out_n[li, pos] = norms[m]
    return out_c, out_n


def _append_placed(state, assign, positions, codes, vids, docids, new_lens):
    li = torch.where(vids < 0, -1, assign)
    return rt.append(state, li, positions, codes, vids, docids, new_lens)


@register_model("IVFPQ")
class IVFPQIndex(RetrievalModel):
    _dump_suffix = "ivfpq"
    # gather-tier payload default; FastScan overrides it to "pq" (its
    # packed codes are the whole point)
    _sq_payload_default = "sq8"
    # the posting codes' layout, as the sharded scan reads it (FastScan
    # packs two 4-bit codes a byte and may code the raw vector instead
    # of the residual)
    packed_codes = False
    by_residual = True

    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(raw_store, params)
        self.p = IVFPQParams.from_dict(params)
        self.d = raw_store.d
        self.device = raw_store.dev
        self._trained = False
        self.centroids: Optional[torch.Tensor] = None      # [nlist, d]
        self.cent_norms: Optional[torch.Tensor] = None
        self.pq: Optional[pq_ops.PQCodebooks] = None
        self.opq_rot: Optional[torch.Tensor] = None        # [d, d] or None
        init_cap = max(64, self.p.bucket_init_size)
        self.state = rt.init_state(self.p.ncentroids, init_cap,
                                   self._code_width(), self.device)
        self.placer = rt.HostPlacer(self.p.ncentroids, init_cap)
        # the dense scan's reconstruction mirror, vid-indexed; float32
        # rows ({"recon_dtype": "float32"}) take the bf16 rounding out of
        # the candidate select at twice the bytes
        rd = str((params or {}).get("recon_dtype", "bfloat16"))
        self.recon_dtype = (torch.float32 if rd == "float32"
                            else torch.bfloat16)
        # a disk-tier store holds no mirror, and neither does its model
        self.keep_recon = raw_store.tier != "disk"
        self._alloc_recon(RECON_ROW_PAD if self.keep_recon else 8)
        self._pending_place: List[Tuple] = []
        # residual-SQ8 sidecar, slot-aligned with the posting lists:
        # allocated at train time, grown with the lists, dropped past
        # SQ_BYTES_BUDGET
        self.sq_payload = (self.p.gather_payload
                           or type(self)._sq_payload_default)
        self.sq_codes: Optional[torch.Tensor] = None  # [nlist, w, d_pad] u8
        self.sq_norms: Optional[torch.Tensor] = None  # [nlist, w] f32
        self.sq_scale: Optional[torch.Tensor] = None  # [d]
        self.sq_off: Optional[torch.Tensor] = None
        self._max_len = 0          # live list-length watermark (host)

    def _code_width(self) -> int:
        """Posting-payload bytes per vector (FastScan packs two 4-bit
        codes per byte)."""
        return self.p.nsubvector

    # ---- training ----

    def trained(self) -> bool:
        return self._trained

    def clamp_train_set(self, x):
        """Clamp to nlist*TRAIN_MAX_PER_LIST rows: a host array by a
        seeded random subset, a tensor (device rows) by a strided slice
        on its own device — the JAX package's subsets of host and device
        arrays."""
        n = x.shape[0]
        hi = self.p.ncentroids * TRAIN_MAX_PER_LIST
        if n <= hi:
            return x
        if torch.is_tensor(x):
            sel = np.linspace(0, n - 1, hi).astype(np.int64)
            return x[torch.from_numpy(sel).to(x.device)]
        return x[np.random.default_rng(0).choice(n, hi, replace=False)]

    def _train_set(self, x) -> torch.Tensor:
        """The clamped train set as f32 rows on the model's device.  `x`
        is a host array or a tensor of any float dtype (a store mirror's
        `device_rows`, bf16 included), which never goes through the
        host."""
        if torch.is_tensor(x):
            return self.clamp_train_set(x).to(self.device, torch.float32)
        return torch.from_numpy(np.ascontiguousarray(
            self.clamp_train_set(np.asarray(x, np.float32)))).to(self.device)

    @staticmethod
    def _pq_train_rows(residuals: torch.Tensor) -> torch.Tensor:
        """Strided subsample for the PQ/SQ codebook fit."""
        n = residuals.shape[0]
        if n <= PQ_TRAIN_MAX_ROWS:
            return residuals
        sel = np.linspace(0, n - 1, PQ_TRAIN_MAX_ROWS).astype(np.int64)
        return residuals[torch.from_numpy(sel).to(residuals.device)]

    def train(self, x, coarse=None) -> None:
        """Fit the OPQ rotation (has_opq), the coarse quantizer (k-means),
        the PQ codebooks and, for the SQ8 payload, the SQ8 ranges on
        residuals of the (clamped) train set: a host array, or device
        rows (`_train_set`).

        `coarse=(centroids[, cent_norms])` seeds the coarse quantizer and
        skips its k-means: index variants over one corpus share ONE
        coarse quantizer.  The centroids must live in THIS model's
        rotated space, so share only between models with the same OPQ
        setting.

        With OPQ the refinement rotates the rows away from the space the
        first quantizers were fit in, so the port fits them again on the
        rows under the final rotation; the JAX package keeps the first
        ones (ROADMAP.md C3)."""
        x0 = self._train_set(x)
        xd = x0
        if self.p.has_opq:
            self.opq_rot = self._train_opq_init(xd)
            xd = xd @ self.opq_rot
        residuals, res_sub = self._fit_quantizers(xd, coarse)
        if self.p.has_opq:
            self._refine_opq(xd, residuals)
            _, res_sub = self._fit_quantizers(self._rotate(x0), coarse)
        if self.sq_payload == "sq8":
            self._sq_init(res_sub)
        self._trained = True

    def _set_coarse(self, coarse) -> None:
        """Take a given coarse quantizer (centroids[, cent_norms])."""
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(
                self.device)
        self.centroids = t(coarse[0])
        self.cent_norms = (t(coarse[1])
                           if len(coarse) > 1 and coarse[1] is not None
                           else l2_norms(self.centroids))

    def _fit_quantizers(self, xd: torch.Tensor, coarse=None):
        """Coarse k-means (or the given `coarse` quantizer) and residual
        PQ codebooks on rotated rows xd → (residuals, their
        codebook-training subsample)."""
        if coarse is not None:
            self._set_coarse(coarse)
        else:
            self.centroids, _ = km.kmeans(
                xd, self.p.ncentroids, iters=10, seed=0,
                rebalance=self.p.train_rebalance)
            self.cent_norms = l2_norms(self.centroids)
        cents = self.centroids
        assign = km.assign_nearest(xd, cents, self.cent_norms)
        residuals = xd - cents[assign]
        res_sub = self._pq_train_rows(residuals)
        self.pq = pq_ops.train_pq(res_sub, self.p.nsubvector,
                                  nbits=self.p.nbits_per_idx, iters=12)
        return residuals, res_sub

    def _train_opq_init(self, x: torch.Tensor) -> torch.Tensor:
        """OPQ rotation init: the PCA basis of x, columns by descending
        eigenvalue, d x d orthogonal (each column fixed up to sign)."""
        xc = x - x.mean(0, keepdim=True)
        _, vecs = torch.linalg.eigh(xc.T @ xc)
        return vecs.flip(1).contiguous()

    def _refine_opq(self, x: torch.Tensor, residuals: torch.Tensor,
                    iters: int = 4) -> None:
        """Alternating OPQ refinement, as the JAX package runs it: encode
        and decode under the current codebooks, solve the procrustes
        rotation R = UVᵀ from the SVD of xᵀ·decode, re-assign x·R and
        retrain the codebooks on its residuals.

        `x` is the train set already rotated by the init rotation, so
        the codebooks end up fit to x0·init·R.  The model keeps that
        product as its rotation; the JAX package keeps R alone, which
        encodes and searches in another space than the codebooks were
        fit in (ROADMAP.md C3)."""
        rot = self.opq_rot
        for _ in range(iters):
            codes = pq_ops.encode_pq(self.pq, residuals)
            recon = pq_ops.decode_pq(self.pq, codes)[:, :self.d]
            u, _, vt = torch.linalg.svd(x.T @ recon, full_matrices=False)
            rot = u @ vt
            xr = x @ rot
            assign = km.assign_nearest(xr, self.centroids, self.cent_norms)
            residuals = xr - self.centroids[assign]
            self.pq = pq_ops.train_pq(residuals, self.p.nsubvector,
                                      nbits=self.p.nbits_per_idx, iters=6)
        self.opq_rot = self.opq_rot @ rot

    def _rotate(self, x: torch.Tensor) -> torch.Tensor:
        if self.opq_rot is not None:
            return x.float() @ self.opq_rot
        return x

    # ---- the dense scan's reconstruction mirror ----

    def _alloc_recon(self, rows: int, **also: Any) -> None:
        """A fresh, empty mirror of `rows` rows, published together with
        the attributes in `also`."""
        # recon_bias: norms + validity in one operand (the unfiltered
        # dense scan adds a single bias row to its scores)
        self._publish(
            recon=torch.zeros((rows, self.d), dtype=self.recon_dtype,
                              device=self.device),
            recon_norms=torch.zeros((rows,), device=self.device),
            recon_valid=torch.full((rows,), BIG, device=self.device),
            recon_bias=torch.full((rows,), BIG, device=self.device),
            **also)

    def _grow_recon(self, need_rows: int) -> None:
        cap = self.recon.shape[0]
        if need_rows <= cap:
            return
        # the mirror will cover every stored row: grow there at once
        new_cap = grow_rows(cap, max(need_rows, self.store.n),
                            quantum=RECON_ROW_PAD)
        pad = new_cap - cap
        f = torch.nn.functional.pad
        self._publish(
            recon=f(self.recon, (0, 0, 0, pad)),
            recon_norms=f(self.recon_norms, (0, pad)),
            recon_valid=f(self.recon_valid, (0, pad), value=BIG),
            recon_bias=f(self.recon_bias, (0, pad), value=BIG))

    def _recon_rows(self, lists: torch.Tensor,
                    codes: torch.Tensor) -> torch.Tensor:
        """Mirror rows of posting codes [n, M] held in `lists`: the
        coarse centroid plus the decoded residual, in recon_dtype."""
        return (self.centroids[lists] + pq_ops.decode_pq(
            self.pq, codes)[:, :self.d]).to(self.recon_dtype)

    def _rebuild_recon(self) -> None:
        """Regenerate the mirror from the posting codes (after a load; the
        reference likewise rebuilds precomputed tables on load,
        gamma_index_ivfpq.cc:1032-1034)."""
        if not self.keep_recon:
            return
        nlist, cap = self.state.vids.shape
        vflat = self.state.vids.reshape(-1)
        live = vflat >= 0
        if not bool(live.any()):
            return
        lists = torch.arange(nlist, device=self.device).repeat_interleave(
            cap)[live]
        cflat = self.state.codes.reshape(nlist * cap, -1)[live]
        vflat = vflat[live]
        self._grow_recon(int(vflat.max()) + 1)
        chunk = 262144
        for s in range(0, vflat.shape[0], chunk):
            rec = self._recon_rows(lists[s:s + chunk], cflat[s:s + chunk])
            self._mirror_set(vflat[s:s + chunk], rec, l2_norms(rec))

    def _mirror_set(self, vids: torch.Tensor, rows: torch.Tensor,
                    row_norms: torch.Tensor) -> None:
        """Publish mirror rows at `vids` (valid, bias = their norms).
        Copy-on-write, as the posting state: a search holding the old
        arrays keeps a consistent snapshot."""
        self._publish(
            recon=_set_rows(self.recon, vids, rows),
            recon_norms=_set_rows(self.recon_norms, vids, row_norms),
            recon_valid=_set_rows(self.recon_valid, vids, 0.0),
            recon_bias=_set_rows(self.recon_bias, vids, row_norms))

    def release_recon(self) -> None:
        """Drop the mirror and serve gather only (the capacity operating
        point); frees ~N*d*2 bytes until a load rebuilds it."""
        with self.mutate_lock:
            self._alloc_recon(8, keep_recon=False)

    # ---- residual-SQ8 gather payload ----

    @property
    def _sq_d_pad(self) -> int:
        return -(-self.d // 128) * 128        # 128-byte code rows

    @property
    def sq_active(self) -> bool:
        return self.sq_codes is not None

    def _sq_over_budget(self, width: int) -> bool:
        return (self.state.nlist * width * (self._sq_d_pad + 4)
                > SQ_BYTES_BUDGET)

    def _sq_init(self, residuals: torch.Tensor) -> None:
        self.sq_scale, self.sq_off = train_sq(residuals)
        # capacity tracks the ladder of the live watermark, not the
        # posting cap (which carries growth slack)
        ce = self._sq_ladder(max(self._max_len, 1))
        if self._sq_over_budget(ce):
            self._sq_drop("init")
            return
        nlist = self.state.nlist
        self._publish(
            sq_codes=torch.zeros((nlist, ce, self._sq_d_pad),
                                 dtype=torch.uint8, device=self.device),
            sq_norms=torch.zeros((nlist, ce), dtype=torch.float32,
                                 device=self.device))

    def _sq_drop(self, why: str) -> None:
        if self.sq_codes is not None or why == "init":
            logging.getLogger("gamma_tpu").warning(
                "SQ8 gather payload dropped (%s): sidecar would exceed "
                "%d MB — gather tier falls back to the ADC scan",
                why, SQ_BYTES_BUDGET >> 20)
        self._publish(sq_codes=None, sq_norms=None)

    def _sq_grow(self, need: int) -> None:
        """Grow the sidecar so every live slot (< `need`) is writable;
        must precede _sq_append (slots past its width are dropped)."""
        if self.sq_codes is None:
            return
        target = self._sq_ladder(need)
        pad = target - self.sq_codes.shape[1]
        if pad <= 0:
            return
        if self._sq_over_budget(target):
            self._sq_drop("grow")
            return
        self._publish(
            sq_codes=torch.nn.functional.pad(self.sq_codes, (0, 0, 0, pad)),
            sq_norms=torch.nn.functional.pad(self.sq_norms, (0, pad)))

    def _sq_ladder(self, need: int) -> int:
        return ladder_256(need, self.state.cap)

    def _cap_eff(self) -> int:
        """Scan width: the ladder step covering the live watermark."""
        return self._sq_ladder(self._max_len)

    def build_sq_sidecar(self, sample_rows: int = 262_144) -> bool:
        """Build the residual-SQ8 sidecar after the fact, from the
        posting state and the store's device mirror: a deployment that
        ingested with gather_payload="pq", or dropped the sidecar past
        its byte budget, moves to the exact-SQ8 gather tier without
        ingesting again.  Fits scale/off on the live residuals of the
        first lists (up to `sample_rows` rows) when they are not fit
        yet, then encodes blocks of lists straight from the mirror.
        Dead slots encode whatever row their clamped vid names; scans
        mask them.  → True when the sidecar is active afterwards.
        Raises without a store mirror (disk tier, released): the rows
        would be read from its 8-row placeholder."""
        assert self._trained, "build_sq_sidecar before train"
        if self.store.tier == "disk" or self.store.released:
            raise RuntimeError(
                "build_sq_sidecar reads the store's device mirror, which "
                "this store does not hold (disk tier or released)")
        with self.mutate_lock:
            self._drain_place()
            st = self.state
            nlist, cap, d_pad = st.nlist, self._cap_eff(), self._sq_d_pad
            self.sq_payload = "sq8"
            if self._sq_over_budget(cap):
                self._sq_drop("build")
                return False
            rows = self.store.device
            vids_ce = st.vids[:, :cap]
            # block size bounds the f32 row gather to ~64 MB
            lb = max(1, min(nlist, (64 << 20) // max(1, cap * self.d * 4)))

            def block(s):
                """Rotated rows of lists [s, s+lb) at every slot, and
                their coarse rows."""
                vb = vids_ce[s:s + lb]
                idx = vb.long().clamp(0, rows.shape[0] - 1).reshape(-1)
                xf = self._rotate(rows[idx].float())
                return vb, xf, self.centroids[s:s + lb].repeat_interleave(
                    cap, dim=0)

            if self.sq_scale is None:
                chunks, got = [], 0
                pos = torch.arange(cap, device=self.device)[None, :]
                for s in range(0, nlist - lb + 1, lb):
                    vb, xf, coarse = block(s)
                    live = ((vb >= 0) & (pos < st.lens[s:s + lb, None])
                            ).reshape(-1)
                    chunks.append((xf - coarse)[live])
                    got += chunks[-1].shape[0]
                    if got >= sample_rows:
                        break
                samp = torch.cat(chunks)[:sample_rows]
                if samp.shape[0] == 0:
                    self._sq_drop("build")
                    return False
                self.sq_scale, self.sq_off = train_sq(samp)
            # zero-filled and written block by block; searches see the
            # sidecar only at the publish below
            sq_codes = torch.zeros((nlist, cap, d_pad), dtype=torch.uint8,
                                   device=self.device)
            sq_norms = torch.zeros((nlist, cap), dtype=torch.float32,
                                   device=self.device)
            for s in range(0, nlist, lb):
                vb, xf, coarse = block(s)
                codes, norms = encode_sq(xf, self.sq_scale, self.sq_off,
                                         coarse, d_pad=d_pad, residual=True)
                sq_codes[s:s + lb] = codes.reshape(vb.shape[0], cap, d_pad)
                sq_norms[s:s + lb] = norms.reshape(vb.shape[0], cap)
            self._publish(sq_codes=sq_codes, sq_norms=sq_norms)
            return True

    # ---- realtime add / update / delete ----

    def _pad_batch(self, x) -> torch.Tensor:
        """A host or device batch → a device tensor padded with zero rows
        to the shape quantum (padding rows carry vid -1 and are dropped
        by every scatter)."""
        n = x.shape[0]
        n_pad = _pad_quantum(n)
        if torch.is_tensor(x):
            xp = x.to(self.device)
        else:
            xp = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
                self.device)
        if n_pad != n:
            xp = torch.nn.functional.pad(xp, (0, 0, 0, n_pad - n))
        return xp

    def _encode_core(self, xp: torch.Tensor):
        """The JAX package's _encode_full over a padded batch: rotate
        (OPQ) → coarse assign → residual PQ encode → mirror rows.  The
        mirror's norms are taken from the STORED (dtype-rounded) rows, so
        the dense scan's ||q||² - 2q·y + ||y||² is the exact distance to
        the stored point.  → (assign [n] i64, codes [n, W] u8, recon
        [n, d], recon_norms [n] f32)."""
        xf = self._rotate(xp.float())
        assign = km.assign_nearest(xf, self.centroids, self.cent_norms)
        codes = pq_ops.encode_pq(self.pq, xf - self.centroids[assign])
        recon = self._recon_rows(assign, codes)
        return assign, codes, recon, l2_norms(recon)

    def encode_batch(self, x):
        """Rotate → assign → residual-encode → reconstruct a host or
        device batch.  Rows are padded to a shape quantum (the device
        outputs stay padded; the numpy list ids are cut back to n).
        → (list_ids np [n], codes [n_pad, W] u8, recon [n_pad, d],
        recon_norms f32 [n_pad])."""
        assign, codes, recon, rnorms = self._encode_core(self._pad_batch(x))
        return assign.cpu().numpy()[:x.shape[0]], codes, recon, rnorms

    def add(self, x, vids: np.ndarray, docids: np.ndarray) -> None:
        """Device ingest: encode → place against the live device lens →
        sidecar scatter → mirror and posting commit.  The one host sync
        is the `need` scalar that gates capacity growth (the reference's
        ExtendBucketMem decision, realtime_mem_data.cc:152-188); the host
        vid→(list, pos) map is refreshed lazily (_drain_place)."""
        assert self._trained, "IVFPQ.add before train"
        n = x.shape[0]
        if n == 0:
            return
        xp = self._pad_batch(x)
        assign, codes, recon, rnorms = self._encode_core(xp)
        idp = np.full((2, xp.shape[0]), -1, np.int64)
        idp[0, :n] = vids
        idp[1, :n] = docids
        idp_d = torch.from_numpy(idp).to(self.device)
        vids_d, docids_d = idp_d[0], idp_d[1]
        positions, new_lens, need_d = _place_batch(
            self.state.lens, assign, vids_d, nlist=self.p.ncentroids)
        need = int(need_d)          # the one host sync on the add path
        if need > self.state.cap:
            new_cap = grow_rows(self.state.cap, need, quantum=1024)
            if new_cap > self.p.bucket_max_size:
                logging.getLogger("gamma_tpu").warning(
                    "list capacity %d exceeds bucket_max_size %d",
                    new_cap, self.p.bucket_max_size)
            # the same lists, wider: a search may hold either
            self.state = rt.grow(self.state, new_cap)
            self.placer.cap = new_cap
        max_len = max(self._max_len, need)
        self._sq_grow(need)
        if self.sq_active:
            # sidecar before the posting publish: a search in between
            # sees consistent state (rows become scannable once posted)
            sqc, sqn = _sq_encode_batch(xp, self.opq_rot, self.centroids,
                                        assign, self.sq_scale, self.sq_off,
                                        d_pad=self._sq_d_pad)
            sq_codes, sq_norms = _sq_append(
                self.sq_codes, self.sq_norms, assign, positions, vids_d,
                sqc, sqn)
            self._publish(sq_codes=sq_codes, sq_norms=sq_norms)
        if self.keep_recon:
            # mirror first: rows turn valid in the mirror before they are
            # posted, which realtime semantics allow
            self._grow_recon(int(np.max(vids)) + 1)
            self._mirror_set(vids_d, recon, rnorms)
        # the lists and the watermark their scan width comes from, as one
        self._publish(
            state=_append_placed(self.state, assign, positions, codes,
                                 vids_d, docids_d, new_lens),
            _max_len=max_len)
        self._pending_place.append(
            (np.asarray(vids, dtype=np.int64).copy(), n, assign, positions))
        if len(self._pending_place) >= 512:
            self._drain_place()
        # high watermark: update re-adds must not move it past fresh rows
        self.indexed_count = max(self.indexed_count, int(np.max(vids)) + 1)

    def _drain_place(self) -> None:
        """Materialize pending device placements into the host placer."""
        if not self._pending_place:
            return
        pend, self._pending_place = self._pending_place, []
        for vids_h, n, assign_d, pos_d in pend:
            self.placer.register(assign_d[:n].cpu().numpy(),
                                 pos_d[:n].cpu().numpy(), vids_h)

    def delete(self, vids: np.ndarray) -> None:
        vids = np.asarray(vids, dtype=np.int64)
        if vids.size == 0:
            return
        self._drain_place()          # host map must cover pending adds
        ls, ps = self.placer.locate(vids)
        live = ls >= 0
        if live.any():
            self.state = rt.tombstone(
                self.state, torch.from_numpy(ls[live]).to(self.device),
                torch.from_numpy(ps[live]).to(self.device))
            self.placer.mark_deleted(vids[live])
            if self.keep_recon:
                dv = torch.from_numpy(vids[live]).to(self.device)
                self._publish(
                    recon_valid=_set_rows(self.recon_valid, dv, BIG),
                    recon_bias=_set_rows(self.recon_bias, dv, BIG))

    def compact(self, threshold: float = 0.3) -> None:
        """Reclaim tombstoned slots when >= 30% are dead (reference
        policy: realtime_mem_data.cc:373-377)."""
        self._drain_place()
        if self.placer.deleted_fraction() < threshold:
            return
        # slots move: the lists, the sidecar aligned with them and the
        # watermark reach a search together or not at all
        if self.sq_active:
            state, (sq_codes, sq_norms) = rt.compact_state_with(
                self.state, (self.sq_codes, self.sq_norms))
        else:
            state = rt.compact_state(self.state)
            sq_codes = sq_norms = None
        lens_np = state.lens.cpu().numpy()
        self._publish(state=state, sq_codes=sq_codes, sq_norms=sq_norms,
                      _max_len=int(lens_np.max(initial=0)))
        self.placer.resync_after_compact(state.docids.cpu().numpy(),
                                         state.vids.cpu().numpy(), lens_np)

    # ---- search ----

    def _snapshot(self) -> types.SimpleNamespace:
        """The searched state as one consistent set, with the scan width
        (`cap_eff`) its own watermark and capacity give."""
        snap = types.SimpleNamespace(
            **dict(zip(_SEARCHED, self._read(*_SEARCHED))))
        snap.cap_eff = ladder_256(snap._max_len, snap.state.cap)
        return snap

    def scan_mode(self, sp: SearchParams, snap=None) -> str:
        """The request's mode, else the model's; "auto" is dense while
        the mirror fits DENSE_BYTES_BUDGET.  Without a mirror (the disk
        tier, release_recon), gather.  Dense over a store whose mirror
        was released raises: X1 would read zero rows for the rerank."""
        snap = snap or self._snapshot()
        if not snap.keep_recon:
            return "gather"
        mode = sp.scan_mode or self.p.scan_mode
        if mode == "auto":
            mirror_bytes = (snap.recon.numel() * snap.recon.element_size()
                            + snap.recon_norms.numel() * 4
                            + snap.recon_valid.numel() * 4)
            mode = ("dense" if mirror_bytes <= DENSE_BYTES_BUDGET
                    else "gather")
        if mode == "dense" and self.store.released:
            raise RuntimeError(
                "dense scan requested but the raw store's device mirror "
                "was released (release_device); call store.flush_device()"
                " to mirror it again or search in gather mode")
        return mode

    def _dense_penalty(self, penalty: torch.Tensor, snap) -> torch.Tensor:
        """The doc-aligned penalty aligned to the mirror's vids, with
        slot validity folded in."""
        cap = snap.recon.shape[0]
        if self.store.vid_mgr.multi:
            v2d = np.full(cap, -1, np.int64)
            src = self.store.vid_mgr._vid2doc
            m = min(cap, src.size)
            v2d[:m] = src[:m]
            idx = torch.from_numpy(v2d).to(penalty.device)
            ok = (idx >= 0) & (idx < penalty.shape[0])
            pen = torch.where(
                ok, penalty[idx.clamp(0, max(penalty.shape[0] - 1, 0))],
                BIG)
        elif penalty.shape[0] >= cap:
            pen = penalty[:cap]
        else:
            pen = torch.nn.functional.pad(
                penalty, (0, cap - penalty.shape[0]), value=BIG)
        return pen + snap.recon_valid

    def _dense_search(self, snap, q, queries, penalty, sp: SearchParams,
                      k: int, recall_num: int, metric: str, dist_range,
                      validity_n):
        """The dense scan over the mirror of `snap`; multi-vid stores map
        the selected vids to docids on the host."""
        multi = self.store.vid_mgr.multi
        if validity_n is not None and dist_range is None and not multi:
            # unfiltered: norms and validity come pre-fused in recon_bias
            bias = snap.recon_valid if metric == "ip" else snap.recon_bias
            d, vids = dense_scan_search_fast(
                snap.recon, bias, q, queries, self.store.device,
                int(validity_n), recall_num=recall_num, k=k, metric=metric,
                rerank=sp.has_rank, recall_target=sp.recall_target)
        else:
            d, vids = dense_scan_search(
                snap.recon, snap.recon_norms, q,
                self._dense_penalty(penalty, snap), self.store.device,
                queries, dist_range, recall_num=recall_num, k=k,
                metric=metric, rerank=sp.has_rank,
                recall_target=sp.recall_target)
        if not multi:
            return d, vids, vids
        v_np = vids.cpu().numpy()
        docids = np.where(v_np < 0, -1, self.store.vid_mgr.vid2doc(
            np.maximum(v_np, 0)))
        return d, torch.from_numpy(docids), vids

    def search(self, queries, penalty, sp: SearchParams, k: int,
               dist_range=None, validity_n=None):
        metric = self.metric_name(sp, self.p.metric_type)
        if not self._trained:
            return self._brute_fallback(queries, penalty, k, metric,
                                        dist_range)
        recall_num = max(sp.recall_num, k)
        q = self._rotate(queries)
        # one published state for the whole search: an ingest, delete or
        # compaction beside it swaps the model's attributes, not these
        snap = self._snapshot()
        if self.scan_mode(sp, snap) == "dense":
            return self._dense_search(snap, q, queries, penalty, sp, k,
                                      recall_num, metric, dist_range,
                                      validity_n)
        nprobe = min(sp.nprobe or self.p.nprobe, self.p.ncentroids)
        if snap.sq_codes is not None:
            # exact-SQ8 scan: top-k straight out of the select;
            # sp.sq_rerank opts into an exact rerank against the store
            # mirror, so only where that mirror is held: without it the
            # rerank would read X1's zero rows
            do_rr = (sp.sq_rerank and sp.has_rank
                     and self.store.tier != "disk"
                     and not self.store.released)
            return ivf_scan.ivfsq_search(
                snap.state, snap.sq_codes, snap.sq_norms, self.sq_scale,
                self.sq_off, self.centroids, self.cent_norms, q,
                penalty, dist_range, validity_n,
                self.store.device if do_rr else None,
                queries if do_rr else None,
                nprobe=nprobe, k=k, metric=metric, cap_eff=snap.cap_eff,
                recall_num=recall_num if do_rr else 0, rerank=do_rr)
        return self._gather_exec(ivf_scan.ivfpq_search, q, queries,
                                 penalty, sp, k, recall_num, metric,
                                 dist_range, nprobe, validity_n, snap)

    def _gather_exec(self, fn, q, queries, penalty, sp: SearchParams,
                     k: int, recall_num: int, metric: str, dist_range,
                     nprobe: int, validity_n=None, snap=None):
        """Run an ADC gather scan `fn` (ivf_scan.ivfpq_search or
        ivfpqfs_search) of the rotated queries `q` over the posting
        state of `snap` (default: a fresh snapshot); sp.has_rank reranks
        the top recall_num exactly with the raw `queries`: against the
        store mirror, or on the disk tier against the candidates' rows
        read from the host (store.get_padded, through its LRU) and
        uploaded (reference: rocksdb_raw_vector.cc GetVector in
        compute_dis)."""
        snap = snap or self._snapshot()
        if self.store.tier != "disk":
            if sp.has_rank and self.store.released:
                raise RuntimeError(
                    "gather rerank needs the store's device mirror but it "
                    "was released; flush_device() or search with "
                    "has_rank=False")
            return fn(snap.state, self.centroids, self.cent_norms, self.pq,
                      q, penalty, self.store.device, queries, dist_range,
                      validity_n, nprobe=nprobe, recall_num=recall_num,
                      k=k, metric=metric, rerank=sp.has_rank,
                      cap_eff=snap.cap_eff)
        rn = max(recall_num, k)
        rd, rdoc, rvid = fn(
            snap.state, self.centroids, self.cent_norms, self.pq, q,
            penalty, self.store.device, queries, dist_range, validity_n,
            nprobe=nprobe, recall_num=rn, k=rn, metric=metric,
            rerank=False, cap_eff=snap.cap_eff)
        if not sp.has_rank:
            return rd[:, :k], rdoc[:, :k], rvid[:, :k]
        rows = self.store.get_padded(rvid.cpu().numpy())     # [B, R, d]
        return ivf_scan.rerank_rows(queries, rd, rdoc, rvid,
                                    torch.from_numpy(rows).to(self.device),
                                    dist_range, k=k, metric=metric)

    # ---- persistence (the JAX package's <field>.ivfpq.npz format) ----

    def _dump_file(self, path: str) -> str:
        return os.path.join(path, f"{self.store.name}.{self._dump_suffix}.npz")

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(self._dump_file(path), **convert.ivfpq_torch_to_arrays(self))

    def load(self, path: str) -> int:
        f = self._dump_file(path)
        if not os.path.exists(f):
            return 0
        with np.load(f) as z:
            st = convert.ivfpq_arrays_to_torch(z, self.device)
        if not st["trained"]:
            return 0
        self.centroids, self.cent_norms = st["centroids"], st["cent_norms"]
        self.pq, state = st["pq"], st["state"]
        self.opq_rot = st["opq_rot"]
        sq_codes = sq_norms = None
        if "sq_codes" in st and self.sq_payload == "sq8":
            sq_codes, sq_norms = st["sq_codes"], st["sq_norms"]
            self.sq_scale, self.sq_off = st["sq_scale"], st["sq_off"]
        # (a dump without the sidecar: the gather tier scans the PQ codes
        # by ADC)
        lens = state.lens.cpu().numpy()
        self._publish(state=state, sq_codes=sq_codes, sq_norms=sq_norms,
                      _max_len=int(lens.max(initial=0)))
        self.placer = rt.HostPlacer(self.state.nlist, self.state.cap)
        self.placer.resync_after_compact(self.state.docids.cpu().numpy(),
                                         self.state.vids.cpu().numpy(), lens)
        self._pending_place = []     # pre-load placements are stale
        self.indexed_count = st["indexed_count"]
        self._trained = True
        self._rebuild_recon()
        return self.indexed_count

    def mem_bytes(self) -> int:
        m = self.state.mem_bytes()
        m += self.recon.numel() * self.recon.element_size()
        m += (self.recon_norms.numel() + self.recon_valid.numel()
              + self.recon_bias.numel()) * 4
        if self.sq_active:
            m += self.sq_codes.numel() + self.sq_norms.numel() * 4
        if self.centroids is not None:
            m += self.centroids.numel() * 4
        if self.pq is not None:
            m += self.pq.codebooks.numel() * 4
        return int(m)
