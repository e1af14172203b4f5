"""Row gather (counterpart of gather_rows_pallas in
experiments/exp_rerank.py, the kernel X1).

    gather_rows(table [n, d], idx [k]) -> [k, d] in table's dtype,
    out[i] = table[idx[i]], a row of zeros where idx[i] is outside [0, n)

It fetches the exact rerank's candidate rows from a store mirror: the
dense scan's rerank (ops/dense_scan.py), the gather tiers' rerank
(ops/ivf_scan._rerank) and the sharded owner-computes rerank
(parallel/sharded.py).  The kernel is csrc/gather_rows.cu: a bulk-copy
(TMA) path for rows of 512 B to 4 KB, a vector path for the others, the
path chosen in the kernel's launcher by row bytes and alignment.

The wrapper launches the CUDA kernel for CUDA tensors and uses the plain
PyTorch version (`_gather_rows_plain`) for CPU tensors; anything else
raises.  LAUNCHES counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"gather_rows": 0}

_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def _gather_rows_plain(table: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version of X1: an indexed read, clamped, then zeroed where
    the index is out of range.  The rows are read through a same-width
    integer view, so the copy is bit for bit on every dtype a store
    mirror can hold (float8_e4m3fn has no masked_fill)."""
    n = table.shape[0]
    idx = idx.long()
    ok = (idx >= 0) & (idx < n)
    if n == 0:
        return table.new_zeros((idx.shape[0], table.shape[1]))
    bits = table.view(_INT_OF_WIDTH[table.element_size()])
    rows = bits[idx.clamp(0, n - 1)].masked_fill(~ok[:, None], 0)
    return rows.view(table.dtype)


def _lib():
    from gamma_tpu_torch.ops import cuda_build
    lib = cuda_build.load("gather_rows")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.gather_rows.argtypes = [vp, ll, vp, i, vp, ll, i, i, vp]
        lib.gather_rows.restype = i
        lib.gather_rows_path.argtypes = [vp, ll, vp, i, vp, ll, i, i, i, vp]
        lib.gather_rows_path.restype = i
        lib._typed = True
    return lib


# the kernel's paths (csrc/gather_rows.cu): None lets it choose by row bytes
_PATHS = {"vector": 0, "bulk": 1}


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    if table.dim() != 2:
        raise TypeError(f"table must be [n, d], got {tuple(table.shape)}")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be [k] int32/int64, got {idx.dtype} "
                        f"{tuple(idx.shape)}")


def _launch(table: torch.Tensor, idx: torch.Tensor,
            path: str | None = None) -> torch.Tensor:
    """One launch of the CUDA kernel on a CUDA table, on the path the
    kernel chooses by row bytes, or on `path` ("vector" or "bulk"), so
    that the threshold between the paths can be measured and both paths
    checked at any k (chip_smoke.py).  A launch the kernel does not take
    raises."""
    if table.device.type != "cuda":
        raise NotImplementedError(f"no gather_rows kernel for {table.device}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous (dense rows)")
    n, d = table.shape
    k = idx.shape[0]
    es = table.element_size()
    row_bytes = d * es
    idx = idx.contiguous()
    out = torch.empty((k, d), dtype=table.dtype, device=table.device)
    vec = (row_bytes % 16 == 0 and table.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    args = (ctypes.c_void_p(table.data_ptr()), n,
            ctypes.c_void_p(idx.data_ptr()), idx.element_size(),
            ctypes.c_void_p(out.data_ptr()), k, row_bytes,
            16 if vec else es)
    with torch.cuda.device(table.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if path is None:
            rc = _lib().gather_rows(*args, stream)
        else:
            rc = _lib().gather_rows_path(*args, _PATHS[path], stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows launch failed: cudaError {rc}")
    LAUNCHES["gather_rows"] += 1
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """X1: table [n, d] with dense rows, idx [k] int32 or int64 → [k, d]
    in table's dtype; an index outside [0, n) gives a row of zeros."""
    _check(table, idx)
    if table.device.type == "cpu":
        return _gather_rows_plain(table, idx)
    return _launch(table, idx)
