"""File IO helpers: fvecs/ivecs/bvecs readers (the SIFT fixture formats the
reference's tests consume — tests/README.md), atomic writes, dir utils.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np


def read_fvecs(path: str, max_n: int = -1) -> np.ndarray:
    """fvecs: per row [int32 d][d x float32]."""
    raw = np.fromfile(path, dtype=np.int32, count=1)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=np.float32)
    d = int(raw[0])
    row_i32 = d + 1
    data = np.fromfile(path, dtype=np.float32)
    n = data.size // row_i32
    if max_n >= 0:
        n = min(n, max_n)
    mat = data[: n * row_i32].reshape(n, row_i32)[:, 1:]
    return np.ascontiguousarray(mat, dtype=np.float32)


def read_ivecs(path: str, max_n: int = -1) -> np.ndarray:
    data = np.fromfile(path, dtype=np.int32)
    if data.size == 0:
        return np.zeros((0, 0), dtype=np.int32)
    d = int(data[0])
    row = d + 1
    n = data.size // row
    if max_n >= 0:
        n = min(n, max_n)
    return np.ascontiguousarray(data[: n * row].reshape(n, row)[:, 1:])


def write_fvecs(path: str, mat: np.ndarray) -> None:
    mat = np.asarray(mat, dtype=np.float32)
    n, d = mat.shape
    out = np.empty((n, d + 1), dtype=np.float32)
    # write the int32 dim via a view to keep the exact bit pattern
    out_view = out.view(np.int32)
    out_view[:, 0] = d
    out[:, 1:] = mat
    out.tofile(path)


def atomic_write_bytes(path: str, data: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


def atomic_write_json(path: str, obj: Any) -> None:
    atomic_write_bytes(path, json.dumps(obj).encode())


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)
