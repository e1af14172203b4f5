"""Grouped SQ8 exact scan — the capacity tier without a rerank gather
(counterpart of gamma_tpu/ops/pallas_gsq.py).

Each vector is stored, in slot order inside its inverted list, as a u8
per-dimension scalar quantization of its residual to the list centroid
plus the exact f32 norm of the dequantized point:

    x_d  ~  c_list,d + off_d + scale_d * code_d
    ||q - x||^2 = ||q||^2 - 2 (q.c_list + q.off + (q*scale).code) + ||x||^2

Queries probing the same list are grouped (ops/gadc.build_groups) and the
(q*scale).code term of every (group, slot) is ONE grouped product — the
kernels B1 (`gsq`) and B2 (`gsq_fold`, which also folds the select's
per-bin min/argmin into the scan) in csrc/gsq.cu.  The per-query and
per-(query, list) constants are added back outside the kernel, with q.c
as a full-f32 GEMM.

The same kernels scan raw bf16 payload rows (the IVFFlat model:
`scale`/`off` None, rows used as they are), and with `precise=True` take
f32 queries and run the product in f32.

Both kernels run the product on the tensor cores (bf16 `mma.sync`, f32
sums: u8 codes and bf16 rows are exact operands, so only the order of
the sum differs from the plain version) and do not multiply a 16-slot
chunk whose operand is all masked; the f32 forms sum by fmaf on the CUDA
cores, a thread per slot.  B1 is bound by its [G, Q, cap] f32 output:
a warp owns 32 slots and all queries, turns its accumulators through a
shared-memory stage into whole 128-byte rows and writes them 16 bytes a
lane; `scan_block_slots` picks the slots a block covers (a whole logical
tile where it can), and blocks in skipped tiles only write.  B2 is bound
by the product: a warp per 16 bins and all queries folds in the
accumulator's layout; `fold_bin_chunk` picks the bins a block covers.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and uses
its plain PyTorch version (`_gsq_plain`, `_gsq_fold_plain`) for CPU
tensors; anything else raises.  LAUNCHES counts kernel launches only,
per form (`launch_key`): the u8 forms under the kernel's name, bf16 rows
under `_bf16`, the f32 product (either row type) under `_precise`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gamma_tpu_torch.ops.gadc import build_groups, default_q_pad, group_bound

LAUNCHES = {"gsq": 0, "gsq_fold": 0, "gsq_bf16": 0, "gsq_fold_bf16": 0,
            "gsq_precise": 0, "gsq_fold_precise": 0}


def launch_key(name: str, codes: torch.Tensor, precise: bool) -> str:
    """The LAUNCHES key of kernel `name` ("gsq" or "gsq_fold") in the
    form these operands select."""
    if precise:
        return name + "_precise"
    return name + ("_bf16" if codes.dtype == torch.bfloat16 else "")

# groups per chunk of the plain versions (bounds their f32 transients)
_PLAIN_GROUPS = 256
# shared memory a block may ask for (the card gives 227 KB)
_SMEM_MAX = 200 * 1024


def _percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Per-column percentile with linear interpolation (numpy's default
    method, which jnp.percentile also uses)."""
    xs = torch.sort(x, dim=0).values
    pos = q / 100.0 * (x.shape[0] - 1)
    lo = int(pos // 1)
    hi = min(lo + 1, x.shape[0] - 1)
    w = pos - lo
    return xs[lo] * (1.0 - w) + xs[hi] * w


def train_sq(x: torch.Tensor, eps: float = 1e-8
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-dimension affine range fit → (scale[d], off[d]) f32 with
    x ~ off + scale * c, c in [0, 255].  The range is clipped at the
    0.05/99.95 percentiles so a few outlier rows do not widen every
    row's step; pass residuals for the residual coding."""
    xf = x.float()
    lo = _percentile(xf, 0.05)
    hi = _percentile(xf, 99.95)
    return (hi - lo).clamp_min(eps) / 255.0, lo


def encode_sq(x: torch.Tensor, scale: torch.Tensor, off: torch.Tensor,
              coarse: Optional[torch.Tensor] = None, *, d_pad: int,
              residual: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (codes [n, d_pad] u8, norms [n] f32).  With residual=True the
    code quantizes x - coarse; norms are always the exact
    ||dequantized point||^2 of the FULL point.  Padding dims encode as 0."""
    xf = x.float()
    base = coarse.float() if residual else 0.0
    c = torch.clamp(torch.round((xf - base - off[None, :]) / scale[None, :]),
                    0.0, 255.0)
    deq = base + off[None, :] + scale[None, :] * c
    norms = (deq * deq).sum(-1)
    codes = c.to(torch.uint8)
    if codes.shape[1] != d_pad:
        codes = torch.nn.functional.pad(codes, (0, d_pad - codes.shape[1]))
    return codes, norms


def fold_geometry(cap: int, tile: int, fold: int):
    """The folded kernel's effective (tile, lb): callers reconstruct
    original slots as (fidx // lb) * tile + arg * lb + (fidx % lb), so
    they must derive the SAME tile the kernel used."""
    tile = min(tile, cap)
    if cap % tile:
        tile = cap
    assert tile % fold == 0, (tile, fold)
    return tile, tile // fold


SCAN_UNIT = 32          # slots a warp of the plain scan covers at a time
SCAN_MAX_SLOTS = 512    # most slots of a list one block covers
SCAN_WARPS = 4


def scan_block_slots(cap: int, tile: int,
                     max_slots: int = SCAN_MAX_SLOTS) -> int:
    """Slots of a list that one block of the CUDA plain scan (B1) covers,
    a multiple of 32 (a warp's unit: one 128-byte line of f32 per query).
    A block stages its group's queries once, so larger is cheaper; and
    the skip rule works in logical tiles, so the largest multiple of 32
    up to `max_slots` that divides `tile` keeps every block wholly
    inside one tile, where it is either scanned or written as dead rows
    without staging anything (tile 512 → 512, 256 → 256, 1280 → 320).
    Where none divides it (tile 1000), `max_slots`, cut to the list
    (cap rounded up to 32): blocks then straddle tiles and the kernel
    decides per 16 slots."""
    tile = min(tile, cap)
    best = 0
    for n in range(SCAN_UNIT, min(tile, max_slots) + 1, SCAN_UNIT):
        if tile % n == 0:
            best = n
    if best:
        return best
    return min(-(-cap // SCAN_UNIT) * SCAN_UNIT, max_slots)


def scan_units(cap: int, span: int):
    """The kernel's walk over one list, mirrored: (block, warp, lo, hi)
    for every 32-slot unit [lo, hi) in the order gsq_kernel visits them —
    block y covers [y*span, (y+1)*span) cut to cap, its warps take the
    units in turn."""
    for y in range(-(-cap // span)):
        b0, b1 = y * span, min(cap, (y + 1) * span)
        for warp in range(SCAN_WARPS):
            for u0 in range(b0 + warp * SCAN_UNIT, b1,
                            SCAN_WARPS * SCAN_UNIT):
                yield y, warp, u0, min(b1, u0 + SCAN_UNIT)


def scan_smem_bytes(q_n: int, d_pad: int) -> int:
    """Dynamic shared memory of one B1 block: the group's queries as
    bf16 fragments (passes of up to 64 queries, in tiles of 8) and a
    [queries per pass, 36] f32 stage per warp."""
    nt = 8 if q_n > 32 else 4 if q_n > 16 else 2 if q_n > 8 else 1
    npass = -(-q_n // (8 * nt))
    return npass * nt * 8 * d_pad * 2 + SCAN_WARPS * nt * 8 * 36 * 4


FOLD_BIN_ROWS = 16      # bins one warp folds at a time (the MMA's rows)
FOLD_MAX_BINS = 640     # most bins of a logical tile one block covers
FOLD_MAX = 32           # the kernel keeps one bit per fold slot


def fold_bin_chunk(lb: int, max_bins: int = FOLD_MAX_BINS) -> int:
    """Bins of a logical tile (lb of them) that one block of the CUDA
    folded scan covers: the largest multiple of 16 up to `max_bins` that
    divides lb, so that no warp's 16 rows hang over the end (lb 608 →
    608, or 304 under max_bins 320; lb 512 → 512 or 256); where none
    divides lb, lb rounded up to 16 rows and cut to 256, the ragged rest
    masked in the kernel.  A block stages its group's queries once, so
    larger is cheaper: at lb 608 one block per (group, tile) measured
    faster than two."""
    best = 0
    for n in range(FOLD_BIN_ROWS, min(lb, max_bins) + 1, FOLD_BIN_ROWS):
        if lb % n == 0:
            best = n
    if best:
        return best
    return min(-(-lb // FOLD_BIN_ROWS) * FOLD_BIN_ROWS, 256)


# ---------------------------------------------------------------------
# plain versions (CPU path, and the oracle the kernels are held against)
# ---------------------------------------------------------------------

def _group_rows(codes, nrm, glist, ntiles, qs, tile, g0, g1):
    """Scanned values of groups [g0, g1) before the skip rule:
    (raw [g, Q, cap] = qs . codes, nrm rows [g, cap], live [g, cap])."""
    lst = glist[g0:g1].long()
    cap = codes.shape[1]
    raw = torch.einsum("gqd,gcd->gqc", qs[g0:g1].float(),
                       codes[lst].float())
    live = (torch.arange(cap, device=codes.device)[None, :]
            < ntiles[g0:g1].long()[:, None] * tile)
    return raw, nrm[lst], live


def _gsq_plain(codes, nrm, glist, ntiles, qs, *, tile: int, alpha: float,
               with_norms: bool, masked: bool) -> torch.Tensor:
    """Plain version of the B1 kernel: [G, Q, cap] f32."""
    g_n, q_n = qs.shape[0], qs.shape[1]
    out = torch.empty((g_n, q_n, codes.shape[1]), dtype=torch.float32,
                      device=codes.device)
    for g0 in range(0, g_n, _PLAIN_GROUPS):
        g1 = min(g_n, g0 + _PLAIN_GROUPS)
        raw, nr, live = _group_rows(codes, nrm, glist, ntiles, qs, tile,
                                    g0, g1)
        nr = nr[:, None, :]
        val = nr - alpha * raw if with_norms else -alpha * raw
        dead = nr if masked else torch.zeros_like(nr)
        out[g0:g1] = torch.where(live[:, None, :], val, dead)
    return out


def _gsq_fold_plain(codes, nrm, glist, ntiles, qs, *, tile: int,
                    alpha: float, fold: int):
    """Plain version of the B2 kernel: ([G, Q, cap/fold] f32,
    [G, Q, cap/fold] i32)."""
    g_n, q_n = qs.shape[0], qs.shape[1]
    cap = codes.shape[1]
    nt, lb = cap // tile, tile // fold
    vals = torch.empty((g_n, q_n, cap // fold), dtype=torch.float32,
                       device=codes.device)
    args = torch.empty((g_n, q_n, cap // fold), dtype=torch.int32,
                       device=codes.device)
    for g0 in range(0, g_n, _PLAIN_GROUPS):
        g1 = min(g_n, g0 + _PLAIN_GROUPS)
        raw, nr, _ = _group_rows(codes, nrm, glist, ntiles, qs, tile, g0, g1)
        dist = (nr[:, None, :] - alpha * raw).reshape(
            g1 - g0, q_n, nt, fold, lb)
        v = dist[:, :, :, 0]
        a = torch.zeros_like(v, dtype=torch.int32)
        for j in range(1, fold):
            m = dist[:, :, :, j] < v
            v = torch.where(m, dist[:, :, :, j], v)
            a = torch.where(m, j, a)
        skip = (torch.arange(nt, device=codes.device)[None, :]
                >= ntiles[g0:g1].long()[:, None])           # [g, nt]
        tmax = nr.reshape(g1 - g0, 1, nt, tile).amax(-1, keepdim=True)
        v = torch.where(skip[:, None, :, None], tmax, v)
        a = torch.where(skip[:, None, :, None], 0, a)
        vals[g0:g1] = v.reshape(g1 - g0, q_n, -1)
        args[g0:g1] = a.reshape(g1 - g0, q_n, -1)
    return vals, args


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------

def _check(codes, nrm, glist, ntiles, qs, precise: bool) -> None:
    if codes.dtype not in (torch.uint8, torch.bfloat16):
        raise TypeError(f"rows must be u8 codes or bf16 rows; got "
                        f"{codes.dtype}")
    qs_dt = torch.float32 if precise else torch.bfloat16
    nlist, cap, d_pad = codes.shape
    g_n, q_n = glist.shape[0], qs.shape[1]
    devs = {t.device for t in (codes, nrm, glist, ntiles, qs)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if (nrm.dtype != torch.float32 or glist.dtype != torch.int32
            or ntiles.dtype != torch.int32 or qs.dtype != qs_dt):
        raise TypeError(f"expected nrm f32, glist/ntiles i32, qs {qs_dt} "
                        f"(precise={precise}); got {nrm.dtype}, "
                        f"{glist.dtype}, {ntiles.dtype}, {qs.dtype}")
    if (tuple(nrm.shape) != (nlist, cap) or tuple(ntiles.shape) != (g_n,)
            or tuple(qs.shape) != (g_n, q_n, d_pad)):
        raise ValueError(
            f"shape mismatch: codes {tuple(codes.shape)}, nrm "
            f"{tuple(nrm.shape)}, glist {tuple(glist.shape)}, ntiles "
            f"{tuple(ntiles.shape)}, qs {tuple(qs.shape)}")
    # rows must be dense; the list axis may be strided (a cap_eff trim
    # of a wider sidecar is a view, not a copy)
    if (codes.stride(2) != 1 or codes.stride(1) != d_pad
            or nrm.stride(1) != 1 or not glist.is_contiguous()
            or not ntiles.is_contiguous() or not qs.is_contiguous()):
        raise ValueError("operands must have dense rows (contiguous slots)")


def _cuda_args(codes, nrm, glist, ntiles, qs, precise):
    # the kernels address the rows in bytes (1 a u8 code, 2 a bf16 value)
    list_bytes = codes.stride(0) * codes.element_size()
    if codes.shape[2] % 16 or list_bytes % 16 or codes.data_ptr() % 16:
        raise ValueError("the CUDA scan reads 16-byte row chunks: d_pad must "
                         "be a multiple of 16, the list stride and the base "
                         "multiples of 16 bytes")
    q_n, d_pad = qs.shape[1], qs.shape[2]
    smem = (-(-q_n // 8) * 8 * d_pad * 4 if precise
            else scan_smem_bytes(q_n, d_pad))
    if smem > _SMEM_MAX:
        raise ValueError(f"Q x d_pad = {q_n} x {d_pad} "
                         "exceeds the kernel's shared-memory stage")
    return [ctypes.c_void_p(codes.data_ptr()),
            ctypes.c_longlong(list_bytes),
            ctypes.c_void_p(nrm.data_ptr()),
            ctypes.c_longlong(nrm.stride(0)),
            ctypes.c_void_p(glist.data_ptr()),
            ctypes.c_void_p(ntiles.data_ptr()),
            ctypes.c_void_p(qs.data_ptr())]


def _lib():
    from gamma_tpu_torch.ops import cuda_build
    lib = cuda_build.load("gsq")
    if not getattr(lib, "_typed", False):
        vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
        lib.gsq_scan.argtypes = [vp, ll, vp, ll, vp, vp, vp, vp,
                                 i, i, i, i, i, i, f, i, i, i, i, vp]
        lib.gsq_scan.restype = i
        lib.gsq_fold_scan.argtypes = [vp, ll, vp, ll, vp, vp, vp, vp, vp,
                                      i, i, i, i, i, i, i, f, i, i, vp]
        lib.gsq_fold_scan.restype = i
        lib._typed = True
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def gsq(codes: torch.Tensor, nrm: torch.Tensor, glist: torch.Tensor,
        ntiles: torch.Tensor, qs: torch.Tensor, *, tile: int, alpha: float,
        with_norms: bool, masked: bool, precise: bool = False
        ) -> torch.Tensor:
    """B1: codes [nlist, cap, d_pad] u8 codes or bf16 rows, nrm [nlist,
    cap] f32, glist / ntiles [G] i32, qs [G, Q, d_pad] bf16 (f32 with
    `precise`, which runs the product in f32) → [G, Q, cap] f32.  `tile`
    is the logical tile of the skip rule (the one build_groups was
    given).  Rows of dead slots must be finite: the kernel does not
    multiply a masked chunk, and BIG - alpha * NaN is not BIG."""
    _check(codes, nrm, glist, ntiles, qs, precise)
    if codes.device.type == "cpu":
        return _gsq_plain(codes, nrm, glist, ntiles, qs, tile=tile,
                          alpha=alpha, with_norms=with_norms, masked=masked)
    if codes.device.type != "cuda":
        raise NotImplementedError(f"no gsq kernel for {codes.device}")
    g_n, q_n, d_pad = qs.shape
    cap = codes.shape[1]
    out = torch.empty((g_n, q_n, cap), dtype=torch.float32,
                      device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gsq_scan(
            *_cuda_args(codes, nrm, glist, ntiles, qs, precise),
            ctypes.c_void_p(out.data_ptr()), g_n, q_n, cap, d_pad, tile,
            scan_block_slots(cap, tile), alpha, int(with_norms),
            int(masked), codes.element_size(), int(precise),
            ctypes.c_void_p(stream))
    _raise_on(rc, "gsq")
    LAUNCHES[launch_key("gsq", codes, precise)] += 1
    return out


def gsq_fold(codes: torch.Tensor, nrm: torch.Tensor, glist: torch.Tensor,
             ntiles: torch.Tensor, qs: torch.Tensor, *, tile: int,
             alpha: float, fold: int, precise: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: operands as `gsq`, bf16 rows and `precise` included (always
    masked: nrm carries the mask bias); `tile` must come from
    fold_geometry → (vals [G, Q, cap/fold] f32, args [G, Q, cap/fold]
    i32)."""
    _check(codes, nrm, glist, ntiles, qs, precise)
    cap = codes.shape[1]
    if cap % tile or tile % fold:
        raise ValueError(f"fold geometry: cap {cap}, tile {tile}, "
                         f"fold {fold}")
    if not 1 <= fold <= FOLD_MAX:
        raise ValueError(f"fold {fold} outside [1, {FOLD_MAX}]")
    if codes.device.type == "cpu":
        return _gsq_fold_plain(codes, nrm, glist, ntiles, qs, tile=tile,
                               alpha=alpha, fold=fold)
    if codes.device.type != "cuda":
        raise NotImplementedError(f"no gsq_fold kernel for {codes.device}")
    g_n, q_n, d_pad = qs.shape
    vals = torch.empty((g_n, q_n, cap // fold), dtype=torch.float32,
                       device=codes.device)
    args = torch.empty((g_n, q_n, cap // fold), dtype=torch.int32,
                       device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gsq_fold_scan(
            *_cuda_args(codes, nrm, glist, ntiles, qs, precise),
            ctypes.c_void_p(vals.data_ptr()), ctypes.c_void_p(args.data_ptr()),
            g_n, q_n, cap, d_pad, tile, fold, fold_bin_chunk(tile // fold),
            alpha, codes.element_size(), int(precise),
            ctypes.c_void_p(stream))
    _raise_on(rc, "gsq_fold")
    LAUNCHES[launch_key("gsq_fold", codes, precise)] += 1
    return vals, args


# ---------------------------------------------------------------------
# the grouped scan
# ---------------------------------------------------------------------

def grouped_sq_scan(codes: torch.Tensor,     # [nlist, cap, d_pad] u8|bf16
                    norms: torch.Tensor,     # [nlist, cap] f32
                    lens: torch.Tensor,      # [nlist] int
                    list_ids: torch.Tensor,  # [B, P] int
                    queries: torch.Tensor,   # [B, d]
                    scale: Optional[torch.Tensor],  # [d] f32; None = raw rows
                    off: Optional[torch.Tensor],    # [d] f32; None = raw rows
                    centroids: Optional[torch.Tensor] = None,  # [nlist, d]
                    *, metric: str = "l2",
                    bias: Optional[torch.Tensor] = None,  # [nlist, cap] f32
                    q_pad: Optional[int] = None,
                    tile: Optional[int] = None,
                    precise: bool = False,
                    fold: int = 1):
    """→ dist [B, P, cap] f32: for L2 the exact ||q - dequant(x)||^2, for
    IP the exact -q.dequant(x).  Without `bias`, tiles beyond a list's
    live length return the query constants only — callers mask by
    length.  With `bias` (ops/ivf_scan.list_bias) the mask rides the
    norms operand and dead slots come out >= BIG.

    `scale`/`off` None: `codes` are raw bf16 rows (the IVFFlat payload)
    and q.x is the product alone.  `precise` hands the kernel f32
    queries and runs the product in f32.

    `centroids` switches to residual decoding: the -alpha q.c_list term
    is added back per (query, probe) from one full-f32 [B, nlist] GEMM.

    fold > 1 (requires `bias`) returns (dist [B, P, cap/fold], args
    [B, P, cap/fold] i32); the original slot of bin f is
    (f // lb) * tile + args * lb + (f % lb) with lb = tile / fold."""
    b, p = list_ids.shape
    nlist, cap, d_pad = codes.shape
    d = queries.shape[1]
    if q_pad is None:
        q_pad = default_q_pad(b, p, nlist)
    if tile is None:
        tile = 512 if fold <= 1 else 4096
    if fold > 1:
        tile, _ = fold_geometry(cap, tile, fold)
    tile = min(tile, cap)
    g_pad = group_bound(b, p, nlist, q_pad)
    glist, ntiles, gpair, pair_gid, pair_slot = build_groups(
        list_ids, lens, q_pad=q_pad, tile=tile, g_pad=g_pad)

    qf = queries.float()
    if scale is None:
        qs_full = qf                                     # [B, d]
        qoff = torch.zeros(b, dtype=torch.float32, device=qf.device)
    else:
        qs_full = qf * scale[None, :]                    # [B, d]
        qoff = qf @ off.float()                          # [B]: q.off
    if d != d_pad:
        qs_full = torch.nn.functional.pad(qs_full, (0, d_pad - d))
    # the kernel operand is rounded to bf16 exactly as the TPU path does
    # (kept in f32 for the precise form)
    qs = qs_full[gpair.clamp_min(0) // p].to(
        torch.float32 if precise else torch.bfloat16).contiguous()

    alpha = 2.0 if metric != "ip" else 1.0
    with_norms = metric != "ip"
    if bias is not None:
        # the mask rides the norms operand (IP: the bias alone)
        nrm = (norms + bias) if with_norms else bias.float()
        with_norms = True
    else:
        nrm = norms
    rows = pair_gid * q_pad + pair_slot
    args = None
    if fold > 1:
        assert bias is not None, "fold requires the fused mask bias"
        og, oa = gsq_fold(codes, nrm, glist, ntiles, qs, tile=tile,
                          alpha=alpha, fold=fold, precise=precise)
        capf = cap // fold
        out = og.reshape(-1, capf)[rows].reshape(b, p, capf)
        args = oa.reshape(-1, capf)[rows].reshape(b, p, capf)
    else:
        og = gsq(codes, nrm, glist, ntiles, qs, tile=tile, alpha=alpha,
                 with_norms=with_norms, masked=bias is not None,
                 precise=precise)
        out = og.reshape(-1, cap)[rows].reshape(b, p, cap)

    if centroids is None:
        const = -qoff if metric == "ip" else (qf * qf).sum(-1) - 2.0 * qoff
        const = const[:, None, None]
    else:
        qc = torch.gather(qf @ centroids.float().T, 1,
                          list_ids.long())                # [B, P]
        if metric == "ip":
            const = -(qc + qoff[:, None])
        else:
            const = ((qf * qf).sum(-1)[:, None]
                     - 2.0 * (qc + qoff[:, None]))
        const = const[..., None]
    out = out + const
    return out if args is None else (out, args)
