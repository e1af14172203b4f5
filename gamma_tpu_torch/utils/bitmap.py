"""Packed bitmap for deleted-doc tracking.

Reference: util/bitmap_manager.{h,cc} — a file-backed global bitmap at bit
granularity with incremental pwrite persistence (bitmap_manager.cc:96-158).

Host side we keep a numpy uint8 bitmap with the same file format contract
(one bit per docid, little-endian within a byte); incremental persistence
writes only dirty byte ranges.  Device side the engine materializes the
bitmap into the f32 penalty array (see ops/penalty.py), so kernels never
do bit math.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np


class BitmapManager:
    """Grow-only bitmap with optional file backing.

    Thread-safety: single-writer / multi-reader like the reference; `set`
    is protected by a lock, `test` reads the numpy buffer racily (reads of
    a monotone bitmap are safe: the only transition is 0->1).
    """

    def __init__(self, capacity_bits: int = 1 << 20):
        self._lock = threading.Lock()
        nbytes = (capacity_bits + 7) // 8
        self.bits = np.zeros(nbytes, dtype=np.uint8)
        self.capacity = nbytes * 8
        self._fd: Optional[int] = None
        self._path: Optional[str] = None
        self.set_count = 0

    # ---- file backing (reference: bitmap_manager.cc Init/Load/Dump) ----

    def open_file(self, path: str, load: bool = False) -> None:
        with self._lock:
            self._path = path
            if load and os.path.exists(path):
                data = np.fromfile(path, dtype=np.uint8)
                if data.size > self.bits.size:
                    self.bits = data.copy()
                    self.capacity = self.bits.size * 8
                else:
                    self.bits[: data.size] = data
                self.set_count = int(np.unpackbits(self.bits).sum())
            self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
            os.pwrite(self._fd, self.bits.tobytes(), 0)

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    # ---- bit ops ----

    def _ensure(self, bit: int) -> None:
        if bit >= self.capacity:
            new_bytes = max((bit // 8) + 1, self.bits.size * 2)
            grown = np.zeros(new_bytes, dtype=np.uint8)
            grown[: self.bits.size] = self.bits
            self.bits = grown
            self.capacity = new_bytes * 8

    def set(self, bit: int) -> None:
        with self._lock:
            self._ensure(bit)
            byte, off = bit >> 3, bit & 7
            if not (self.bits[byte] >> off) & 1:
                self.bits[byte] |= np.uint8(1 << off)
                self.set_count += 1
                if self._fd is not None:
                    # incremental persistence at byte granularity
                    os.pwrite(self._fd, bytes([int(self.bits[byte])]), byte)

    def unset(self, bit: int) -> None:
        with self._lock:
            self._ensure(bit)
            byte, off = bit >> 3, bit & 7
            if (self.bits[byte] >> off) & 1:
                self.bits[byte] &= np.uint8(~(1 << off) & 0xFF)
                self.set_count -= 1
                if self._fd is not None:
                    os.pwrite(self._fd, bytes([int(self.bits[byte])]), byte)

    def test(self, bit: int) -> bool:
        if bit >= self.capacity:
            return False
        return bool((self.bits[bit >> 3] >> (bit & 7)) & 1)

    def test_many(self, bits: np.ndarray) -> np.ndarray:
        """Vectorized test; out-of-range bits read as False."""
        bits = np.asarray(bits, dtype=np.int64)
        inr = (bits >= 0) & (bits < self.capacity)
        safe = np.where(inr, bits, 0)
        vals = (self.bits[safe >> 3] >> (safe & 7).astype(np.uint8)) & 1
        return np.where(inr, vals.astype(bool), False)

    def as_bool_array(self, n: int) -> np.ndarray:
        """First n bits as a bool vector (for device penalty build).
        Takes the lock: _ensure may swap the bits array, and a concurrent
        set() against the discarded array would lose a delete."""
        with self._lock:
            nbytes = (n + 7) // 8
            self._ensure(n - 1 if n > 0 else 0)
            bits = self.bits[:nbytes].copy()
        unpacked = np.unpackbits(bits, bitorder="little")
        return unpacked[:n].astype(bool)

    def mem_bytes(self) -> int:
        return int(self.bits.size)
