"""Grouped ADC scan over PQ codes, and the query grouping shared by the
grouped posting-list scans (counterpart of gamma_tpu/ops/pallas_gadc.py).

The grouped kernels invert the (query, probe) → list mapping: queries
probing the same inverted list form a group of at most q_pad slots, so
one pass over a list's codes serves every query in the group
(build_groups; ops/gsq.py uses it too).

The grouped ADC scan (the kernel B3, csrc/gadc.cu) decomposes the L2
ADC distance exactly as the TPU kernel does:

  ||q - (c_L + res(x))||^2 = ||q - c_L||^2
                             + sum_m (||cb[m, code_m]||^2
                                      - 2 r_m . cb[m, code_m])

with r = q - c_L, so that per (query, list) one LUT
cbn - alpha (r . CB) serves every slot of the list; the caller adds the
coarse term.  IP uses r = q, alpha 1 and cbn = 0; raw-coded FastScan
uses r = q, alpha 2 and the caller adds ||q||^2.  8-bit codes hold one
byte per subquantizer; packed 4-bit codes hold subquantizer 2j in the
low nibble of byte j and 2j+1 in its high nibble.

The kernel wrapper `gadc` launches the CUDA kernel for CUDA tensors and
uses its plain PyTorch version `_gadc_plain` for CPU tensors; anything
else raises.  LAUNCHES counts kernel launches only.

The CUDA kernel keeps its LUT in shared memory as bf16, the 8 queries of
a block side by side in one 16-byte entry per (subquantizer, code), so a
lookup is one 16-byte load for 8 queries; `gadc_geometry` picks, per
operand shapes, how many subquantizers one LUT stage holds (16 at ksub
256: 64 KB, two blocks to an SM; each entry is built once per group and
query, on the tensor cores), how large a unit of codebook rows the build
streams through shared memory, and how many slots a block covers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gamma_tpu_torch.ops import pq as pq_ops

LAUNCHES = {"gadc": 0}
# the CUDA kernel's launch geometry (csrc/gadc.cu holds the same limits)
GADC_QUERIES = 8               # queries per block, one 16-byte LUT entry
GADC_ENTRY_BYTES = 2 * GADC_QUERIES
GADC_LUT_BYTES = 64 * 1024     # shared memory of one LUT stage
GADC_SPAN = 1280               # slots per block (256 threads x 5)
GADC_STAGE_CODE_BYTES = 16     # code bytes per slot a stage holds
GADC_UNIT_BYTES = 12 * 1024    # codebook rows + norms of one build unit
SMEM_LIMIT = 232_448           # dynamic shared memory a block may take
# groups per chunk of the plain version (bounds its [g, Q, cap, M]
# gather transient)
_PLAIN_GROUPS = 16


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


# ---------------------------------------------------------------------
# the grouped ADC kernel (B3)
# ---------------------------------------------------------------------

def flat_codebook(pq: pq_ops.PQCodebooks, packed: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's operands: [M, ksub, dsub] codebooks flattened
    into the block-diagonal CBm [M*dsub, M*ksub] (bf16) and the flat
    norms cbn [1, M*ksub] (f32).

    For the packed-nibble layout the column blocks follow the TPU
    kernel's unpack order (all low nibbles, then all high nibbles: block
    j holds subquantizer 2j for j < M/2, else 2(j - M/2) + 1) while the
    rows stay in true feature order."""
    m, ksub, dsub = pq.codebooks.shape
    dev = pq.codebooks.device
    if packed:
        perm = torch.cat([torch.arange(0, m, 2, device=dev),
                          torch.arange(1, m, 2, device=dev)])
    else:
        perm = torch.arange(m, device=dev)
    cb_t = pq.codebooks.float().transpose(1, 2)            # [M, dsub, ksub]
    z = torch.zeros((m, dsub, m, ksub), dtype=torch.float32, device=dev)
    # column block j holds subquantizer perm[j]; its rows are that
    # subquantizer's true feature dims
    z[perm, :, torch.arange(m, device=dev), :] = cb_t[perm]
    cbm = z.reshape(m * dsub, m * ksub)
    cbn = pq.cb_norms.float()[perm].reshape(1, m * ksub)
    return cbm.to(torch.bfloat16), cbn


def _unpack_columns(codes: torch.Tensor, packed: bool) -> torch.Tensor:
    """Code rows → per-column-block codes in the TPU kernel's order."""
    if not packed:
        return codes
    return torch.cat([codes & 15, codes >> 4], dim=-1)


def _gadc_plain(codes, glist, ntiles, rg, cb, cbn, bias, *, tile: int,
                alpha: float, packed: bool) -> torch.Tensor:
    """Plain version of B3 in the TPU kernel's own formulation: the LUT
    as one product with the flat block-diagonal codebook
    (flat_codebook), rounded to bf16, and the one-hot product over
    column blocks in its unpack order, done as a gather → [G, Q, cap]."""
    g_n, q_n = rg.shape[0], rg.shape[1]
    cap = codes.shape[1]
    m, ksub, _ = cb.shape
    cbm, cbn_f = flat_codebook(pq_ops.PQCodebooks(cb, cbn), packed)
    col0 = torch.arange(m, device=codes.device) * ksub
    out = torch.empty((g_n, q_n, cap), dtype=torch.float32,
                      device=codes.device)
    for g0 in range(0, g_n, _PLAIN_GROUPS):
        g1 = min(g_n, g0 + _PLAIN_GROUPS)
        gs = g1 - g0
        lst = glist[g0:g1].long()
        ip = rg[g0:g1].float() @ cbm.float()                # [g, Q, MK]
        lut = (cbn_f - alpha * ip).to(torch.bfloat16).float()
        cols = _unpack_columns(codes[lst], packed).long() + col0
        picked = torch.gather(lut, 2, cols.reshape(gs, 1, cap * m).expand(
            gs, q_n, cap * m)).reshape(gs, q_n, cap, m)
        acc = picked.sum(-1)
        live = (torch.arange(cap, device=codes.device)[None, :]
                < ntiles[g0:g1].long()[:, None] * tile)[:, None, :]
        if bias is None:
            out[g0:g1] = torch.where(live, acc, 0.0)
        else:
            b = bias[lst][:, None, :]
            out[g0:g1] = torch.where(live, acc + b, b)
    return out


def _check_gadc(codes, glist, ntiles, rg, cb, cbn, bias, packed) -> None:
    ops = [codes, glist, ntiles, rg, cb, cbn] + (
        [] if bias is None else [bias])
    devs = {t.device for t in ops}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if (codes.dtype != torch.uint8 or glist.dtype != torch.int32
            or ntiles.dtype != torch.int32 or rg.dtype != torch.bfloat16
            or cb.dtype != torch.bfloat16 or cbn.dtype != torch.float32
            or (bias is not None and bias.dtype != torch.float32)):
        raise TypeError("expected codes u8, glist/ntiles i32, rg/cb bf16, "
                        "cbn/bias f32")
    nlist, cap, w = codes.shape
    m, ksub, dsub = cb.shape
    g_n = glist.shape[0]
    if (packed and (2 * w != m or ksub > 16)) or (not packed and w != m):
        raise ValueError(f"code width {w} does not hold M {m} x ksub "
                         f"{ksub} (packed={packed})")
    if ksub > 256:
        raise ValueError(f"ksub {ksub} exceeds u8 codes")
    if (rg.dim() != 3 or tuple(rg.shape[::2]) != (g_n, m * dsub)
            or tuple(ntiles.shape) != (g_n,)
            or tuple(cbn.shape) != (m, ksub)
            or (bias is not None and tuple(bias.shape) != (nlist, cap))):
        raise ValueError(
            f"shape mismatch: codes {tuple(codes.shape)}, glist "
            f"{tuple(glist.shape)}, ntiles {tuple(ntiles.shape)}, rg "
            f"{tuple(rg.shape)}, cb {tuple(cb.shape)}, cbn "
            f"{tuple(cbn.shape)}, bias "
            f"{None if bias is None else tuple(bias.shape)}")
    # rows must be dense; the list axis may be strided (a cap_eff trim
    # of the posting state is a view, not a copy)
    if (codes.stride(2) != 1 or codes.stride(1) != w
            or (bias is not None and bias.stride(1) != 1)
            or not all(t.is_contiguous() for t in (glist, ntiles, rg, cb,
                                                   cbn))):
        raise ValueError("operands must have dense rows (contiguous slots)")


def gadc_geometry(cap: int, m: int, ksub: int, dsub: int, packed: bool
                  ) -> dict:
    """Launch geometry of the CUDA kernel for one operand shape:
      span   slots per block (cap split evenly into blocks of <= 1280),
      mc     subquantizers per LUT stage: as many as GADC_LUT_BYTES of
             16-byte entries and 16 code bytes a slot hold (even when
             packed, so that a stage starts on a byte),
      stages LUT stages per block (the f32 sums wait in registers),
      tu     16-entry codebook tiles per build unit: the rows (bf16) and
             norms (f32) that GADC_UNIT_BYTES hold, at most a stage's,
      smem   dynamic shared memory in bytes: the LUT stage, two unit
             buffers and the block's 8 residual rows (bf16); above
             SMEM_LIMIT the wrapper raises."""
    per_m = ksub * GADC_ENTRY_BYTES
    mc = min(m, GADC_LUT_BYTES // per_m,
             GADC_STAGE_CODE_BYTES * (2 if packed else 1))
    if packed:
        mc -= mc % 2
    if mc < 1:
        raise ValueError(f"no LUT stage holds ksub {ksub} (packed={packed})")
    tile_bytes = 16 * (2 * dsub + 4)
    tu = max(1, min(GADC_UNIT_BYTES // tile_bytes, mc * _cdiv(ksub, 16)))
    smem = mc * per_m + 2 * tu * tile_bytes + GADC_QUERIES * m * dsub * 2
    return {"span": _cdiv(cap, _cdiv(cap, GADC_SPAN)), "mc": mc,
            "stages": _cdiv(m, mc), "tu": tu, "smem": smem}


def _lib():
    from gamma_tpu_torch.ops import cuda_build
    lib = cuda_build.load("gadc")
    if not getattr(lib, "_typed", False):
        vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
        lib.gadc_scan.argtypes = [vp, ll, vp, vp, vp, vp, vp, vp, ll, vp,
                                  i, i, i, i, i, i, i, i, f, i, i, i, i, i,
                                  vp]
        lib.gadc_scan.restype = i
        lib._typed = True
    return lib


def gadc(codes: torch.Tensor, glist: torch.Tensor, ntiles: torch.Tensor,
         rg: torch.Tensor, cb: torch.Tensor, cbn: torch.Tensor,
         bias: Optional[torch.Tensor] = None, *, tile: int, alpha: float,
         packed: bool) -> torch.Tensor:
    """B3: codes [nlist, cap, W] u8 (W = M, or M/2 packed), glist /
    ntiles [G] i32, rg [G, Q, M*dsub] bf16, cb [M, ksub, dsub] bf16,
    cbn [M, ksub] f32, bias None or [nlist, cap] f32 → [G, Q, cap] f32.
    `tile` is the logical tile of the skip rule (the one build_groups
    was given)."""
    _check_gadc(codes, glist, ntiles, rg, cb, cbn, bias, packed)
    if codes.device.type == "cpu":
        return _gadc_plain(codes, glist, ntiles, rg, cb, cbn, bias,
                           tile=tile, alpha=alpha, packed=packed)
    if codes.device.type != "cuda":
        raise NotImplementedError(f"no gadc kernel for {codes.device}")
    _, cap, w = codes.shape
    m, ksub, dsub = cb.shape
    g_n, q_n = rg.shape[0], rg.shape[1]
    geo = gadc_geometry(cap, m, ksub, dsub, packed)
    if geo["smem"] > SMEM_LIMIT:
        raise ValueError(f"M {m} x dsub {dsub} needs {geo['smem']} bytes of "
                         f"shared memory (limit {SMEM_LIMIT})")
    if cb.data_ptr() % 16 or cbn.data_ptr() % 16:
        raise ValueError("cb and cbn must be 16-byte aligned")
    stage_bytes = geo["mc"] // 2 if packed else geo["mc"]
    vec16 = not (w % 16 or stage_bytes % 16 or codes.stride(0) % 16
                 or codes.data_ptr() % 16)
    out = torch.empty((g_n, q_n, cap), dtype=torch.float32,
                      device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gadc_scan(
            ctypes.c_void_p(codes.data_ptr()), codes.stride(0),
            ctypes.c_void_p(glist.data_ptr()),
            ctypes.c_void_p(ntiles.data_ptr()),
            ctypes.c_void_p(rg.data_ptr()), ctypes.c_void_p(cb.data_ptr()),
            ctypes.c_void_p(cbn.data_ptr()),
            ctypes.c_void_p(None if bias is None else bias.data_ptr()),
            0 if bias is None else bias.stride(0),
            ctypes.c_void_p(out.data_ptr()), g_n, q_n, cap, m, ksub, dsub,
            w, tile, alpha, int(packed), geo["span"], geo["mc"], int(vec16),
            geo["tu"], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"gadc launch failed: cudaError {rc}")
    LAUNCHES["gadc"] += 1
    return out


def grouped_adc(codes: torch.Tensor,        # [nlist, cap, W] u8
                lens: torch.Tensor,         # [nlist] int
                list_ids: torch.Tensor,     # [B, P] int
                queries: torch.Tensor,      # [B, d]
                centroids: torch.Tensor,    # [nlist, d] f32
                pq: pq_ops.PQCodebooks,
                *, metric: str = "l2", packed: bool = False,
                residual: bool = True,
                bias: Optional[torch.Tensor] = None,  # [nlist, cap] f32
                q_pad: Optional[int] = None,
                tile: Optional[int] = None) -> torch.Tensor:
    """→ adc [B, P, cap] f32 with adc[b, p, c] =
         sum_m ||cb[m, code]||^2 - 2 r_{b,p} . cb[m, code]   (L2, residual)
         sum_m ||cb[m, code]||^2 - 2 q_b . cb[m, code]       (L2, raw: the
             caller adds ||q||^2 for the full distance)
         sum_m                 - q_b . cb[m, code]           (IP)
    so that the full distance is coarse[b, p] + adc (residual L2, IP) or
    ||q||^2 + adc (raw L2).

    Without `bias`, tiles beyond a list's live length return 0.0 and
    callers mask by length.  With `bias` (ops/ivf_scan.list_bias) the
    mask rides the scan: masked slots come out >= BIG and skipped tiles
    emit their (all-BIG) bias."""
    b, p = list_ids.shape
    cap = codes.shape[1]
    m, ksub = pq.M, pq.ksub
    if q_pad is None:
        q_pad = default_q_pad(b, p, codes.shape[0])
    if tile is None:
        tile = 256 if m * ksub >= 4096 else 512
    tile = min(tile, cap)
    g_pad = group_bound(b, p, codes.shape[0], q_pad)
    glist, ntiles, gpair, pair_gid, pair_slot = build_groups(
        list_ids, lens, q_pad=q_pad, tile=tile, g_pad=g_pad)

    qg = queries.float()[gpair.clamp_min(0) // p]           # [G, Q, d]
    if metric == "ip":
        rg, alpha = qg, 1.0
    elif residual:
        rg, alpha = qg - centroids.float()[glist.long()][:, None, :], 2.0
    else:
        rg, alpha = qg, 2.0
    dp = pq.d_padded
    if rg.shape[-1] != dp:
        rg = torch.nn.functional.pad(rg, (0, dp - rg.shape[-1]))
    cbn = (torch.zeros_like(pq.cb_norms) if metric == "ip"
           else pq.cb_norms).float().contiguous()
    og = gadc(codes, glist, ntiles, rg.to(torch.bfloat16).contiguous(),
              pq.codebooks.to(torch.bfloat16).contiguous(), cbn,
              None if bias is None else bias.float(), tile=tile,
              alpha=alpha, packed=packed)                   # [G, Q, cap]
    rows = pair_gid * q_pad + pair_slot
    return og.reshape(-1, cap)[rows].reshape(b, p, cap)
