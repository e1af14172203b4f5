"""Per-(query, probe) ADC table scans (counterpart of
gamma_tpu/ops/pallas_adc.py).

Each (query, probe) pair scans the PQ codes of its probed inverted list
against a precomputed f32 lookup table and sums one entry per
subquantizer:

    adc:     dist[b, p, s] = sum_m lut[b, p, m, codes[l, s, m]]     (B4)
    adc_fs:  dist[b, p, s] = sum_m lut[b, m, nibble_m(codes[l, s])] (B5)

with l = list_ids[b, p].  B4 is the IVFPQ gather tier's scan when the
grouped ADC kernel (ops/gadc.py, B3) does not take the geometry
(M*ksub % 128 != 0); B5 is the FastScan scan with one table per query
over packed 4-bit codes.  Both kernels live in csrc/adc.cu: a block
stages its pair's table and the contiguous bytes of up to 1024 code rows
in shared memory (16-byte asynchronous copies, all in flight at once),
and each thread sums its slots' lookups from there.

Each wrapper launches its CUDA kernel for CUDA tensors and uses its
plain PyTorch version (`_adc_plain`, `_adc_fs_plain`) for CPU tensors;
anything else raises.  LAUNCHES counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

from gamma_tpu_torch.ops import pq as pq_ops

LAUNCHES = {"adc": 0, "adc_fs": 0}
# code bytes gathered per chunk of the plain versions (bounds transients)
_PLAIN_BYTES = 1 << 26
# the kernels stage one table and some 24 KB of code rows (at least 256
# rows) per block in shared memory
_SMEM_MAX = 200 * 1024


def _smem_bytes(table_floats: int, row_bytes: int) -> int:
    return 4 * table_floats + max(24 * 1024, 256 * row_bytes) + 48


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """[..., W] u8 packed → [..., 2W] u8 codes in 0..15 (low nibble
    first: byte j holds subquantizer 2j low, 2j+1 high)."""
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1])


# ---------------------------------------------------------------------
# plain versions (CPU path, and the oracle the kernels are held against)
# ---------------------------------------------------------------------

def _query_chunks(b: int, per_query: int):
    step = max(1, _PLAIN_BYTES // max(1, per_query))
    for b0 in range(0, b, step):
        yield b0, min(b, b0 + step)


def _adc_plain(codes, list_ids, lut) -> torch.Tensor:
    """Plain version of B4: gather the probed lists, sum the looked-up
    entries (pq.adc_scan) → [B, P, cap] f32."""
    b, p = list_ids.shape
    _, cap, m = codes.shape
    out = torch.empty((b, p, cap), dtype=torch.float32, device=codes.device)
    for b0, b1 in _query_chunks(b, p * cap * m):
        codes_g = codes[list_ids[b0:b1].long()]            # [b, P, cap, M]
        out[b0:b1] = pq_ops.adc_scan(lut[b0:b1], codes_g)
    return out


def _adc_fs_plain(codes, list_ids, lut) -> torch.Tensor:
    """Plain version of B5: unpack the probed lists' nibbles and sum the
    query's looked-up entries → [B, P, cap] f32."""
    b, p = list_ids.shape
    _, cap, w = codes.shape
    out = torch.empty((b, p, cap), dtype=torch.float32, device=codes.device)
    for b0, b1 in _query_chunks(b, p * cap * 2 * w):
        codes_g = unpack_nibbles(codes[list_ids[b0:b1].long()])
        out[b0:b1] = pq_ops.adc_scan(lut[b0:b1, None], codes_g)
    return out


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------

def _check(codes, list_ids, lut, lut_dims: int) -> None:
    devs = {t.device for t in (codes, list_ids, lut)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if codes.dtype != torch.uint8 or codes.dim() != 3:
        raise TypeError(f"codes must be [nlist, cap, W] u8, got "
                        f"{codes.dtype} {tuple(codes.shape)}")
    if lut.dtype != torch.float32 or lut.dim() != lut_dims:
        raise TypeError(f"lut must be {lut_dims}-d f32, got {lut.dtype} "
                        f"{tuple(lut.shape)}")
    if list_ids.dim() != 2 or list_ids.dtype not in (torch.int32,
                                                      torch.int64):
        raise TypeError(f"list_ids must be [B, P] int, got "
                        f"{list_ids.dtype} {tuple(list_ids.shape)}")
    if lut.shape[0] != list_ids.shape[0]:
        raise ValueError(f"lut {tuple(lut.shape)} vs list_ids "
                         f"{tuple(list_ids.shape)}")
    # rows must be dense; the list axis may be strided (a cap_eff trim)
    if codes.stride(2) != 1 or codes.stride(1) != codes.shape[2]:
        raise ValueError("codes must have dense rows (contiguous slots)")


def _lib():
    from gamma_tpu_torch.ops import cuda_build
    lib = cuda_build.load("adc")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.adc_scan.argtypes = [vp, ll, vp, vp, ll, ll, vp, i, i, i, i, i,
                                 vp]
        lib.adc_scan.restype = i
        lib.adc_fs_scan.argtypes = [vp, ll, vp, vp, vp, i, i, i, i, vp]
        lib.adc_fs_scan.restype = i
        lib._typed = True
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def adc(codes: torch.Tensor, list_ids: torch.Tensor,
        lut: torch.Tensor) -> torch.Tensor:
    """B4: codes [nlist, cap, M] u8, list_ids [B, P] int, lut [B, P, M,
    ksub] f32 (the B and P axes may be strided, e.g. a broadcast
    per-query table) → [B, P, cap] f32."""
    _check(codes, list_ids, lut, 4)
    b, p = list_ids.shape
    _, cap, m = codes.shape
    if tuple(lut.shape[1:3]) != (p, m):
        raise ValueError(f"lut {tuple(lut.shape)} vs list_ids "
                         f"{tuple(list_ids.shape)} and M {m}")
    ksub = lut.shape[3]
    if codes.device.type == "cpu":
        return _adc_plain(codes, list_ids, lut)
    if codes.device.type != "cuda":
        raise NotImplementedError(f"no adc kernel for {codes.device}")
    if lut.stride(3) != 1 or lut.stride(2) != ksub:
        raise ValueError("each pair's [M, ksub] table must be contiguous")
    if _smem_bytes(m * ksub, m) > _SMEM_MAX:
        raise ValueError(f"M x ksub = {m} x {ksub} exceeds the kernel's "
                         "shared-memory table")
    ids = list_ids.to(torch.int32).contiguous()
    out = torch.empty((b, p, cap), dtype=torch.float32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().adc_scan(
            ctypes.c_void_p(codes.data_ptr()), codes.stride(0),
            ctypes.c_void_p(ids.data_ptr()), ctypes.c_void_p(lut.data_ptr()),
            lut.stride(0), lut.stride(1), ctypes.c_void_p(out.data_ptr()),
            b * p, p, cap, m, ksub, ctypes.c_void_p(stream))
    _raise_on(rc, "adc")
    LAUNCHES["adc"] += 1
    return out


def adc_fs(codes: torch.Tensor, list_ids: torch.Tensor,
           lut: torch.Tensor) -> torch.Tensor:
    """B5: codes [nlist, cap, M/2] u8 packed nibbles, list_ids [B, P]
    int, lut [B, M, 16] f32 (one table per query) → [B, P, cap] f32."""
    _check(codes, list_ids, lut, 3)
    b, p = list_ids.shape
    _, cap, w = codes.shape
    if tuple(lut.shape[1:]) != (2 * w, 16):
        raise ValueError(f"lut {tuple(lut.shape)} vs packed width {w}")
    if codes.device.type == "cpu":
        return _adc_fs_plain(codes, list_ids, lut)
    if codes.device.type != "cuda":
        raise NotImplementedError(f"no adc_fs kernel for {codes.device}")
    if _smem_bytes(2 * w * 16, w) > _SMEM_MAX:
        raise ValueError(f"M = {2 * w} exceeds the kernel's shared-memory "
                         "table")
    ids = list_ids.to(torch.int32).contiguous()
    lut = lut.contiguous()
    out = torch.empty((b, p, cap), dtype=torch.float32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().adc_fs_scan(
            ctypes.c_void_p(codes.data_ptr()), codes.stride(0),
            ctypes.c_void_p(ids.data_ptr()), ctypes.c_void_p(lut.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), b * p, p, cap, w,
            ctypes.c_void_p(stream))
    _raise_on(rc, "adc_fs")
    LAUNCHES["adc_fs"] += 1
    return out
