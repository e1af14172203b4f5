"""Row-block LRU cache for the disk tier.

Reference: storage/lru_cache.h:332 — gamma's LRUCache<block_id, block>
in front of disk segments, runtime-resizable via SetConfig
(gamma_engine.cc:1366-1382 AlterCacheSize).  Here the cached unit is a
block of raw-vector rows read from the host memmap; the exact-rerank
fetch path (RawVectorStore.get_padded) reads through it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import numpy as np


class BlockLRU:
    def __init__(self, fetch: Callable[[int, int], np.ndarray],
                 row_bytes: int, block_rows: int = 4096,
                 capacity_bytes: int = 64 << 20):
        """fetch(start_row, end_row) → np rows; row_bytes sizes the
        eviction accounting."""
        self._fetch = fetch
        self.block_rows = block_rows
        self._block_bytes = row_bytes * block_rows
        self._capacity = max(capacity_bytes, self._block_bytes)
        self._blocks: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def set_capacity(self, capacity_bytes: int) -> None:
        with self._lock:
            self._capacity = max(capacity_bytes, self._block_bytes)
            self._evict_locked()

    def _evict_locked(self) -> None:
        while len(self._blocks) * self._block_bytes > self._capacity:
            self._blocks.popitem(last=False)

    def get(self, block: int) -> np.ndarray:
        with self._lock:
            arr = self._blocks.get(block)
            if arr is not None:
                self._blocks.move_to_end(block)
                self.hits += 1
                return arr
            self.misses += 1
        s = block * self.block_rows
        arr = np.array(self._fetch(s, s + self.block_rows))
        with self._lock:
            self._blocks[block] = arr
            self._evict_locked()
        return arr

    def invalidate(self, blocks) -> None:
        with self._lock:
            for b in np.unique(np.asarray(blocks, np.int64)):
                self._blocks.pop(int(b), None)

    def mem_bytes(self) -> int:
        return len(self._blocks) * self._block_bytes

    def clear(self) -> None:
        with self._lock:
            self._blocks.clear()
