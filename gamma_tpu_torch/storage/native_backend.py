"""Incremental persistence over the native storage engine.

Reference: storage/storage_manager.h:57-120 + storage/async_writer.cc:51-110
— the reference's durability backbone: table rows, string heap, and raw
vectors live in append-only mmap'd segments that a background thread syncs
incrementally; Dump() is just Sync() + a consistency marker, so checkpoint
cost is O(delta since last sync), not O(corpus).

This module binds that contract to the engine's columnar host state:

  * ColumnStore   — per numeric field one NativeStorage (fixed-width
                    items = the column dtype), per string field a shared
                    string heap + an 8-byte handle column, plus a handle
                    column for doc keys.  `flush(table, dirty)` appends
                    rows beyond the persisted watermark and re-writes
                    dirty (updated) rows; old string bytes leak in the
                    heap until compaction, as in the reference's string
                    blocks.
  * VectorPersist — one NativeStorage of d*4-byte rows per vector field,
                    appended at device-flush time and point-updated on
                    vector updates.

Both are host-side mmaps: appends are memcpys, the native syncer thread
plays AsyncWriter (msync MS_ASYNC on dirty segments), and `sync()` is the
durable MS_SYNC barrier the engine's dump() uses before writing its
commit marker.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from gamma_tpu_torch import native
from gamma_tpu_torch.config import DataType, FIXED_WIDTH_NUMPY, FieldInfo

SEG_ITEMS = 500_000            # reference segment size (table.cc:138-146)
STR_BYTES_PER_SEG = 64 << 20


class ColumnStore:
    """Native-segment persistence for a Table's columns + string heaps."""

    def __init__(self, directory: str, fields: List[FieldInfo],
                 compress: bool = False):
        assert native.available()
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.fields = fields
        self.numeric: Dict[str, native.NativeStorage] = {}
        self.handles: Dict[str, native.NativeStorage] = {}

        def column(name: str, itemsize: int):
            if compress:
                # zstd-compressed table blocks (reference:
                # storage/compress/compressor_zstd.h): ~64 KB raw blocks
                # sealed as zstd frames, read through a block LRU
                return native.ZBlockStorage(
                    directory, name, row_bytes=itemsize,
                    rows_per_block=max(1024, (64 << 10) // itemsize))
            return native.NativeStorage(
                directory, name, item_size=itemsize,
                segment_items=SEG_ITEMS)

        # one shared string heap (rows unused: item_size=1, tiny row cap)
        self.heap = native.NativeStorage(
            directory, "tbl_strs", item_size=1, segment_items=64,
            str_bytes_per_seg=STR_BYTES_PER_SEG)
        for f in fields:
            if f.data_type == DataType.STRING:
                self.handles[f.name] = column(f"tblh_{f.name}", 8)
            else:
                itemsize = np.dtype(FIXED_WIDTH_NUMPY[f.data_type]).itemsize
                self.numeric[f.name] = column(f"tbl_{f.name}", itemsize)
        self.keyh = column("tblh__dockey", 8)

    # ---- write path ----

    def persisted(self) -> int:
        counts = [len(s) for s in self.numeric.values()]
        counts += [len(s) for s in self.handles.values()]
        counts.append(len(self.keyh))
        return min(counts) if counts else 0

    def _put_str(self, s: str) -> int:
        return self.heap.add_str(s.encode())

    def flush(self, table, dirty: Optional[List[int]] = None) -> int:
        """Append rows [persisted, table.n) and re-write dirty rows.
        Caller holds the engine ingest lock (single writer)."""
        start, end = self.persisted(), table.n
        if end > start:
            for name, st in self.numeric.items():
                st.add(np.ascontiguousarray(table.columns[name][start:end]))
            for name, st in self.handles.items():
                heap = table.heaps[name]
                st.add(self.heap.add_strs(
                    [heap.get(d).encode() for d in range(start, end)]))
            self.keyh.add(self.heap.add_strs(
                [str(table.doc_keys[d]).encode()
                 for d in range(start, end)]))
        for d in dirty or ():
            if d >= start:      # appended above with current values
                continue
            for name, st in self.numeric.items():
                st.update(d, np.ascontiguousarray(table.columns[name][d]))
            for name, st in self.handles.items():
                h = self._put_str(table.heaps[name].get(d))
                st.update(d, np.int64(h))
        return max(0, end - start)

    def sync(self) -> None:
        for st in self.numeric.values():
            st.sync()
        for st in self.handles.values():
            st.sync()
        self.heap.sync()
        self.keyh.sync()

    # ---- read path ----

    def load_into(self, table, n: int) -> int:
        """Restore the first n rows into the table's host state."""
        n = min(n, self.persisted())
        if n <= 0:
            return 0
        table._grow(max(n, 1))
        for name, st in self.numeric.items():
            dt = table.columns[name].dtype
            table.columns[name][:n] = st.get_range(0, n, dt)
        for name, st in self.handles.items():
            hs = st.get_range(0, n, np.int64)
            # ONE native crossing for the whole column (per-row get_str
            # spends minutes in ctypes at 10M rows)
            table.heaps[name].put_all(0, self.heap.get_strs(hs))
        ks = self.keyh.get_range(0, n, np.int64)
        table.doc_keys = [b.decode() for b in self.heap.get_strs(ks)]
        table.n = n
        return n

    def truncate(self, n: int) -> None:
        for st in self.numeric.values():
            st.truncate(n)
        for st in self.handles.values():
            st.truncate(n)
        self.keyh.truncate(n)

    def close(self) -> None:
        for st in self.numeric.values():
            st.close()
        for st in self.handles.values():
            st.close()
        self.heap.close()
        self.keyh.close()


class VectorPersist:
    """Native-segment persistence for one raw-vector field.  Rows persist
    in the store's host dtype — with the f16 compression tier the on-disk
    segments are half-width too (the disk-size role of the reference's
    ZFP block compression, storage/compress/compressor_zfp.h)."""

    def __init__(self, directory: str, name: str, d: int,
                 dtype=np.float32, compress: bool = False):
        assert native.available()
        self.d = d
        self.dtype = np.dtype(dtype)
        if compress:
            # zstd block compression of the vector segments (reference:
            # storage/compress/compressor_zfp.h vector blocks): sealed
            # blocks are immutable zstd frames; updates overlay
            rb = d * self.dtype.itemsize
            self.store = native.ZBlockStorage(
                directory, f"vec_{name}", row_bytes=rb,
                rows_per_block=max(1024, (256 << 10) // rb))
        else:
            self.store = native.NativeStorage(
                directory, f"vec_{name}",
                item_size=d * self.dtype.itemsize,
                segment_items=SEG_ITEMS)

    def __len__(self) -> int:
        return len(self.store)

    def append(self, rows: np.ndarray) -> None:
        self.store.add(np.ascontiguousarray(rows, dtype=self.dtype))

    def update(self, vid: int, row: np.ndarray) -> None:
        self.store.update(
            vid, np.ascontiguousarray(row, dtype=self.dtype))

    def read(self, start: int, count: int) -> np.ndarray:
        return self.store.get_range(start, count, self.dtype
                                    ).reshape(-1, self.d).astype(
                                        np.float32)

    def sync(self) -> None:
        self.store.sync()

    def truncate(self, n: int) -> None:
        self.store.truncate(n)

    def close(self) -> None:
        self.store.close()
