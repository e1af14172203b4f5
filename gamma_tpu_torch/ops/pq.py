"""Product quantization: train / encode / decode (counterpart of
gamma_tpu/ops/pq.py).

Training is ONE batched k-means over all M subspaces
(kmeans_batched_fit); encode is a batched distance GEMM + argmin per
subspace.  d is zero-padded up to a multiple of M (zeros contribute
nothing to L2/IP).  The ADC lookup tables (l2_lut / ip_lut) and the
plain table scan (adc_scan) serve the PQ gather payload: they are the
per-(query, probe) operands of the ADC kernels (ops/adc.py) and the
plain versions they are held against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gamma_tpu_torch.ops import kmeans as km


class PQCodebooks(NamedTuple):
    codebooks: torch.Tensor    # [M, ksub, dsub] f32
    cb_norms: torch.Tensor     # [M, ksub] f32 squared norms

    @property
    def M(self) -> int:
        return self.codebooks.shape[0]

    @property
    def ksub(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def d_padded(self) -> int:
        return self.M * self.dsub


def codebooks_from(cb: torch.Tensor) -> PQCodebooks:
    cb = cb.float()
    return PQCodebooks(cb, (cb * cb).sum(-1))


def padded_dim(d: int, M: int) -> int:
    return -(-d // M) * M


def split_subspaces(x: torch.Tensor, M: int) -> torch.Tensor:
    """[..., d] → [..., M, dsub] f32, zero-padding d to a multiple of M."""
    x = x.float()
    d = x.shape[-1]
    dp = padded_dim(d, M)
    if dp != d:
        x = torch.nn.functional.pad(x, (0, dp - d))
    return x.reshape(*x.shape[:-1], M, dp // M)


def train_pq(x: torch.Tensor, M: int, *, nbits: int = 8, iters: int = 12,
             seed: int = 0) -> PQCodebooks:
    """Train M codebooks of 2^nbits centroids each on x [n, d]."""
    ksub = 1 << nbits
    sub = split_subspaces(x, M).transpose(0, 1).contiguous()  # [M, n, dsub]
    n = sub.shape[1]
    g = torch.Generator().manual_seed(seed)
    if n >= ksub:
        perm = torch.randperm(n, generator=g)[:ksub].to(sub.device)
        inits = sub[:, perm, :]
    else:
        inits = sub.repeat(1, -(-ksub // n), 1)[:, :ksub, :]
        inits = inits + 1e-5 * torch.randn(inits.shape, generator=g).to(
            sub.device)
    cents, _ = km.kmeans_batched_fit(sub, inits, k=ksub, iters=iters)
    return codebooks_from(cents)


def encode_pq(pq: PQCodebooks, x: torch.Tensor, *,
              chunk: int = 16384) -> torch.Tensor:
    """x [n, d] → codes u8 [n, M] (nearest codebook entry per subspace)."""
    sub = split_subspaces(x, pq.M)                          # [n, M, dsub]
    out = torch.empty((sub.shape[0], pq.M), dtype=torch.uint8,
                      device=sub.device)
    for s in range(0, sub.shape[0], chunk):
        c = sub[s:s + chunk]
        cross = torch.einsum("cmd,mkd->cmk", c, pq.codebooks)
        dist = ((c * c).sum(-1)[:, :, None] - 2.0 * cross
                + pq.cb_norms[None, :, :])
        out[s:s + chunk] = torch.argmin(dist, dim=-1).to(torch.uint8)
    return out


def decode_pq(pq: PQCodebooks, codes: torch.Tensor) -> torch.Tensor:
    """codes u8 [n, M] → reconstructed vectors [n, d_padded] f32."""
    m_idx = torch.arange(pq.M, device=codes.device)[None, :]
    rec = pq.codebooks[m_idx, codes.long()]                 # [n, M, dsub]
    return rec.reshape(codes.shape[0], pq.d_padded)


def l2_lut(pq: PQCodebooks, residuals: torch.Tensor) -> torch.Tensor:
    """ADC tables for L2: residuals [..., d] → LUT [..., M, ksub] f32 with
    LUT[m, k] = ||r_m - cb[m, k]||^2."""
    sub = split_subspaces(residuals, pq.M)                  # [..., M, dsub]
    cross = torch.einsum("...md,mkd->...mk", sub, pq.codebooks)
    rn = (sub * sub).sum(-1)                                # [..., M]
    return rn[..., None] - 2.0 * cross + pq.cb_norms


def ip_lut(pq: PQCodebooks, queries: torch.Tensor) -> torch.Tensor:
    """ADC tables for inner product: LUT[m, k] = q_m . cb[m, k]."""
    sub = split_subspaces(queries, pq.M)
    return torch.einsum("...md,mkd->...mk", sub, pq.codebooks)


def adc_scan(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Sum the LUT entries the codes select: lut [..., M, ksub] f32 and
    codes [..., C, M] u8 (the lut's leading dims broadcast against the
    codes') → dist [..., C] f32 with dist[c] = sum_m lut[m, codes[c, m]]."""
    idx = codes.long().transpose(-1, -2)                    # [..., M, C]
    lead = torch.broadcast_shapes(lut.shape[:-2], idx.shape[:-2])
    picked = torch.gather(lut.expand(*lead, *lut.shape[-2:]), -1,
                          idx.expand(*lead, *idx.shape[-2:]))
    return picked.sum(-2)
