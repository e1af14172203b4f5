"""fvecs/ivecs/bvecs dataset readers (TexMex format) + a real-dataset
resolver for bench/tests.

The reference's fixtures and benchmarks run on real SIFT data:
tests/README.md invokes `./test_files profile_10k.txt
siftsmall_base.fvecs`, and benchs/README.md publishes SIFT1M/SIFT10M
recall tables.  This environment has zero egress, so the files cannot
be fetched — bench.py defaults to the synthetic SIFT-geometry corpus
and switches to real data when `GAMMA_BENCH_DATA=/path/to/sift` points
at a TexMex-layout directory.

Format (http://corpus-texmex.irisa.fr): every row is a little-endian
int32 component count followed by that many components — float32 for
.fvecs, int32 for .ivecs, uint8 for .bvecs.  All rows in one file share
the same dimension.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np


def _read_vecs(path: str, comp_dtype, count: Optional[int] = None,
               offset_rows: int = 0) -> np.ndarray:
    """Memory-mapped TexMex reader → [n, d] array of comp_dtype."""
    comp = np.dtype(comp_dtype)
    with open(path, "rb") as f:
        head = np.fromfile(f, dtype="<i4", count=1)
        if head.size == 0:
            return np.empty((0, 0), comp)
        d = int(head[0])
    if d <= 0 or d > (1 << 24):
        raise ValueError(f"{path}: implausible row dimension {d}")
    row_bytes = 4 + d * comp.itemsize
    total = os.path.getsize(path)
    if total % row_bytes:
        raise ValueError(f"{path}: size {total} not a multiple of the "
                         f"row stride {row_bytes} (d={d})")
    n_all = total // row_bytes
    start = min(offset_rows, n_all)
    n = n_all - start if count is None else min(count, n_all - start)
    mm = np.memmap(path, dtype=np.uint8, mode="r",
                   offset=start * row_bytes, shape=(n * row_bytes,))
    rows = mm.reshape(n, row_bytes)
    # per-row dim headers must all agree
    dims = rows[:, :4].copy().view("<i4").reshape(n)
    if n and not (dims == d).all():
        bad = int(np.flatnonzero(dims != d)[0])
        raise ValueError(f"{path}: row {start + bad} has dim {dims[bad]}"
                         f" != {d}")
    out = rows[:, 4:].copy().view(comp).reshape(n, d)
    del mm
    return out


def read_fvecs(path: str, count: Optional[int] = None,
               offset_rows: int = 0) -> np.ndarray:
    return _read_vecs(path, "<f4", count, offset_rows)


def read_ivecs(path: str, count: Optional[int] = None,
               offset_rows: int = 0) -> np.ndarray:
    return _read_vecs(path, "<i4", count, offset_rows)


def read_bvecs(path: str, count: Optional[int] = None,
               offset_rows: int = 0) -> np.ndarray:
    return _read_vecs(path, np.uint8, count, offset_rows)


def write_fvecs(path: str, x: np.ndarray) -> None:
    """Inverse of read_fvecs (test fixtures; tools)."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    out = np.empty((n, 1 + d), "<f4")
    out[:, 0:1].view("<i4")[:] = d
    out[:, 1:] = x
    out.tofile(path)


def write_ivecs(path: str, x: np.ndarray) -> None:
    x = np.asarray(x, "<i4")
    n, d = x.shape
    out = np.empty((n, 1 + d), "<i4")
    out[:, 0] = d
    out[:, 1:] = x
    out.tofile(path)


def load_texmex_dir(data_dir: str, max_base: Optional[int] = None,
                    max_queries: Optional[int] = None
                    ) -> Optional[Dict[str, np.ndarray]]:
    """Resolve a TexMex-layout directory → {"base", "query", "gt"(opt)}.

    Accepts the standard file names (sift_base.fvecs / *_base.fvecs,
    *_query.fvecs, *_groundtruth.ivecs); returns None (caller falls back
    to synthetic) when base or query is missing.  gt rows are 0-based
    nearest-neighbor ids ordered by distance (the TexMex convention)."""
    def find(pat):
        hits = sorted(glob.glob(os.path.join(data_dir, pat)))
        return hits[0] if hits else None

    base_p = find("*_base.fvecs") or find("base.fvecs")
    query_p = find("*_query.fvecs") or find("query.fvecs")
    if base_p is None or query_p is None:
        return None
    out = {"base": read_fvecs(base_p, count=max_base),
           "query": read_fvecs(query_p, count=max_queries)}
    gt_p = find("*_groundtruth.ivecs") or find("groundtruth.ivecs")
    if gt_p is not None:
        out["gt"] = read_ivecs(gt_p, count=max_queries)
    return out
