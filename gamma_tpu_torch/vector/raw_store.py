"""Raw vector store: host master + device mirror (counterpart of
gamma_tpu/vector/raw_store.py).

  * HOST master: a grow-by-doubling numpy array (f32, or f16 with
    host_dtype=float16; a disk memmap for store_type "Mmap" and "Disk")
    — the source of truth for persistence, GetVector and training reads.
  * DEVICE mirror: a [cap, d] bf16 (or f32) tensor used by the flat
    scan and the exact rerank, with norms computed from the rows AS
    STORED so norm-expansion distances are exact to the stored values.

The mirror is copy-on-write: a flush publishes a new tensor, so a search
holding the previous one is never written under.

The disk tier (store_type "Disk", or "RocksDB" as the reference names
it; reference: vector/rocksdb_raw_vector.cc — vectors beyond RAM, read
through on demand) keeps NO device mirror: the memmap is the master,
scans run over codes on the card, and the exact rerank uploads just the
candidate rows, read through a row-block LRU (`get_padded`).
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from gamma_tpu_torch.utils.device import resolve_device


class VIDMgr:
    """vid↔docid maps (identity when each doc has exactly one vector)."""

    def __init__(self, multi_vids: bool = False):
        self.multi = multi_vids
        self._vid2doc = np.zeros(0, dtype=np.int64)
        self._doc_first_vid = np.zeros(0, dtype=np.int64)

    def note(self, docid: int, vids: np.ndarray) -> None:
        if not self.multi:
            return
        hi = int(vids.max()) + 1
        if hi > self._vid2doc.size:
            grown = np.full(max(hi, 2 * self._vid2doc.size + 1024), -1,
                            dtype=np.int64)
            grown[: self._vid2doc.size] = self._vid2doc
            self._vid2doc = grown
        if docid >= self._doc_first_vid.size:
            grown = np.full(max(docid + 1, 2 * self._doc_first_vid.size
                                + 1024), -1, dtype=np.int64)
            grown[: self._doc_first_vid.size] = self._doc_first_vid
            self._doc_first_vid = grown
        self._vid2doc[vids] = docid
        if self._doc_first_vid[docid] < 0:
            self._doc_first_vid[docid] = int(vids.min())

    def vid2doc(self, vids: np.ndarray) -> np.ndarray:
        if not self.multi:
            return np.asarray(vids)
        return self._vid2doc[np.asarray(vids)]

    def doc2vid(self, docid: int) -> int:
        if not self.multi:
            return docid
        return int(self._doc_first_vid[docid])

    def doc_vids(self, docid: int) -> np.ndarray:
        """ALL vids of a doc (store.add assigns a doc's vids contiguously,
        so they are the run of _vid2doc == docid from the first vid)."""
        if not self.multi:
            return np.array([docid], dtype=np.int64)
        first = int(self._doc_first_vid[docid])
        if first < 0:
            return np.zeros(0, dtype=np.int64)
        end = first
        while end < self._vid2doc.size and self._vid2doc[end] == docid:
            end += 1
        return np.arange(first, end, dtype=np.int64)


class RawVectorStore:
    def __init__(self, name: str, dimension: int, *,
                 store_type: str = "MemoryOnly",
                 root_path: str = "",
                 device_dtype=torch.bfloat16,
                 host_dtype=np.float32,
                 init_cap: int = 8192,
                 multi_vids: bool = False,
                 compress_dumps: bool = False,
                 compress_blocks: bool = False,
                 device=None):
        self.name = name
        self.d = dimension
        if store_type == "RocksDB":     # reference cold tier → disk tier
            store_type = "Disk"
        self.store_type = store_type
        self.root_path = root_path
        self.device_dtype = device_dtype
        self.host_dtype = np.dtype(host_dtype)
        self.compress_dumps = compress_dumps
        self.compress_blocks = compress_blocks
        # the mirror lives on the card unless the caller asks for the CPU
        self.dev = resolve_device(device, "RawVectorStore")
        self.n = 0                       # number of vectors (vids) stored
        self._flushed = 0                # rows mirrored to device
        # mirror dropped by release_device(): a consumer that gathers rows
        # from `device` (dense scan, rerank) must check this — X1 reads
        # zero rows outside the placeholder, silently wrong distances
        self.released = False
        self._lock = threading.Lock()
        self.vid_mgr = VIDMgr(multi_vids)
        self._host_cap = init_cap
        self._host = self._alloc_host(init_cap)
        # the disk tier holds an 8-row placeholder and never grows it
        cap = 8 if self.tier == "disk" else init_cap
        self.device = torch.zeros((cap, dimension), dtype=device_dtype,
                                  device=self.dev)
        self.device_norms = torch.zeros((cap,), dtype=torch.float32,
                                        device=self.dev)
        self._persist = None          # see attach_persist()
        # disk tier: row-block LRU in front of the memmap (reference:
        # storage/lru_cache.h:332; resized at run time by SetConfig)
        self._row_cache = None
        if self.tier == "disk":
            from gamma_tpu_torch.utils.lru import BlockLRU
            self._row_cache = BlockLRU(
                lambda s, e: self._host[s:e],
                row_bytes=self.host_dtype.itemsize * dimension,
                capacity_bytes=64 << 20)

    @property
    def tier(self) -> str:
        """"ram" (MemoryOnly/Mmap: full device mirror) or "disk" (no
        device mirror, the rerank reads through)."""
        return "disk" if self.store_type == "Disk" else "ram"

    # ---- incremental native persistence ----

    def attach_persist(self, directory: str) -> None:
        from gamma_tpu_torch.storage.native_backend import VectorPersist
        self._persist = VectorPersist(directory, self.name, self.d,
                                      dtype=self.host_dtype,
                                      compress=self.compress_blocks)

    def flush_storage(self) -> int:
        """Append host rows not yet in the native segments."""
        if self._persist is None:
            return 0
        with self._lock:
            start, end = len(self._persist), self.n
            if end > start:
                self._persist.append(self._host[start:end])
            return max(0, end - start)

    def sync_storage(self) -> None:
        if self._persist is not None:
            self._persist.sync()

    def load_persist(self, limit: int) -> int:
        """Restore rows from native segments (truncated to limit)."""
        if self._persist is None:
            return 0
        n = min(limit, len(self._persist))
        self._persist.truncate(n)
        if n <= 0:
            return 0
        self._reset()
        self.add(self._persist.read(0, n))
        self.flush_device()
        return n

    def close_persist(self) -> None:
        if self._persist is not None:
            self._persist.close()
            self._persist = None

    def _reset(self) -> None:
        """Empty the store before a restore writes its rows again."""
        self.n = 0
        self._flushed = 0
        if self._row_cache is not None:
            self._row_cache.clear()

    # ---- host tier ----

    def _alloc_host(self, cap: int) -> np.ndarray:
        if self.store_type in ("Mmap", "Disk") and self.root_path:
            os.makedirs(self.root_path, exist_ok=True)
            path = os.path.join(self.root_path, f"{self.name}.vec")
            return np.lib.format.open_memmap(
                path, mode="w+", dtype=self.host_dtype,
                shape=(cap, self.d))
        return np.zeros((cap, self.d), dtype=self.host_dtype)

    def _grow_host(self, need: int) -> None:
        new_cap = self._host_cap
        while new_cap < need:
            new_cap *= 2
        if self.store_type in ("Mmap", "Disk") and self.root_path:
            # open_memmap(mode="w+") truncates the inode the live memmap
            # still backs — grow via a sibling file, then replace
            path = os.path.join(self.root_path, f"{self.name}.vec")
            tmp = path + ".grow"
            fresh = np.lib.format.open_memmap(
                tmp, mode="w+", dtype=self.host_dtype,
                shape=(new_cap, self.d))
            fresh[: self.n] = self._host[: self.n]
            fresh.flush()
            os.replace(tmp, path)
            # one assignment: a reader beside the growth (a search's
            # rerank fetch) holds the old mapping or the new, never none
            self._host = fresh
        else:
            fresh = self._alloc_host(new_cap)
            fresh[: self.n] = self._host[: self.n]
            self._host = fresh
        self._host_cap = new_cap

    # ---- public API (mirrors RawVector Add/Update/GetVector/Gets) ----

    def add(self, rows: np.ndarray) -> np.ndarray:
        """Append rows [n, d]; returns assigned vids."""
        rows = np.asarray(rows, dtype=np.float32).reshape(-1, self.d)
        with self._lock:
            start = self.n
            need = start + rows.shape[0]
            if need > self._host_cap:
                self._grow_host(need)
            self._host[start:need] = rows
            self.n = need
            return np.arange(start, need, dtype=np.int64)

    def update(self, vids: np.ndarray, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.float32).reshape(-1, self.d)
        vids = np.asarray(vids, dtype=np.int64)
        with self._lock:
            self._host[vids] = rows
            if self._row_cache is not None:
                self._row_cache.invalidate(vids // self._row_cache.block_rows)
            if self._persist is not None:
                persisted = len(self._persist)
                for i, v in enumerate(vids):
                    if v < persisted:   # newer rows append at next flush
                        self._persist.update(int(v), rows[i])
            flushed = vids < self._flushed
            if flushed.any():
                vv = torch.from_numpy(vids[flushed]).to(self.dev)
                rr = torch.from_numpy(rows[flushed]).to(
                    self.dev, self.device_dtype)
                dev, norms = self.device.clone(), self.device_norms.clone()
                dev[vv] = rr
                norms[vv] = (rr.float() ** 2).sum(1)
                self.device, self.device_norms = dev, norms

    def get(self, vids: np.ndarray) -> np.ndarray:
        return self._host[np.asarray(vids, dtype=np.int64)].astype(
            np.float32)

    def get_padded(self, vids: np.ndarray) -> np.ndarray:
        """Rows by vid, f32, with negative or out-of-range ids clamped to a
        valid row (callers mask those slots by distance) — the disk tier's
        rerank fetch (reference: rocksdb_raw_vector.cc GetVector), read
        through the row-block LRU when one is attached: whole blocks from
        the cache, the growing tail block straight from the host."""
        v = np.asarray(vids, dtype=np.int64)
        v = np.clip(v, 0, max(self.n - 1, 0))
        cache = self._row_cache
        if cache is None:
            return self._host[v].astype(np.float32)
        with self._lock:
            # under the store's lock: an update's write and the
            # invalidation of its block cannot fall between a block's
            # read and its insertion into the cache
            return self._read_through(v, cache)

    def _read_through(self, v: np.ndarray, cache) -> np.ndarray:
        """The rows of ids `v` (clamped) as f32, in their order: the ids
        sorted by block, each block's rows taken into one contiguous
        host-dtype stage, then widened and put back in order by torch
        (numpy's float16 widening cost more than the rest together)."""
        flat = v.reshape(-1)
        bs = cache.block_rows
        order = np.argsort(flat // bs, kind="stable")
        ids = flat[order]
        blocks = ids // bs
        cuts = np.flatnonzero(np.diff(blocks)) + 1
        staged = np.empty((flat.size, self.d), self.host_dtype)
        for s, e in zip(np.r_[0, cuts], np.r_[cuts, flat.size]):
            if e <= s:
                continue
            b = int(blocks[s])
            if (b + 1) * bs <= self.n:           # full block: cacheable
                np.take(cache.get(b), ids[s:e] - b * bs, axis=0,
                        out=staged[s:e])
            else:                                # growing tail: direct
                staged[s:e] = self._host[ids[s:e]]
        out = torch.empty((flat.size, self.d), dtype=torch.float32)
        out[torch.from_numpy(order)] = torch.from_numpy(staged).float()
        return out.numpy().reshape(v.shape + (self.d,))

    def set_cache_bytes(self, capacity_bytes: int) -> None:
        if self._row_cache is not None:
            self._row_cache.set_capacity(capacity_bytes)

    def cache_mem_bytes(self) -> int:
        return self._row_cache.mem_bytes() if self._row_cache else 0

    def header(self, start: int, end: int) -> np.ndarray:
        """Zero-copy span of the host tier (GetVectorHeader analog)."""
        return self._host[start:end]

    # ---- device mirror ----

    def flush_device(self) -> int:
        """Mirror any host rows not yet on the device (a new tensor is
        published; growth follows utils/growth.grow_rows).  Returns rows
        flushed (always 0 on the disk tier, which holds no mirror)."""
        if self.tier == "disk":
            return 0
        with self._lock:
            start, end = self._flushed, self.n
            if end <= start:
                return 0
            cap = self.device.shape[0]
            if end > cap:
                from gamma_tpu_torch.utils.growth import grow_rows
                cap = grow_rows(cap, end)
            dev = torch.zeros((cap, self.d), dtype=self.device_dtype,
                              device=self.dev)
            norms = torch.zeros((cap,), dtype=torch.float32,
                                device=self.dev)
            dev[:start] = self.device[:start]
            norms[:start] = self.device_norms[:start]
            rows = torch.from_numpy(
                np.ascontiguousarray(self._host[start:end], np.float32)
            ).to(self.dev).to(self.device_dtype)
            dev[start:end] = rows
            norms[start:end] = (rows.float() ** 2).sum(1)
            self.device, self.device_norms = dev, norms
            self._flushed = end
            self.released = False        # the mirror is current again
            return end - start

    @property
    def flushed(self) -> int:
        return self._flushed

    def release_device(self) -> None:
        """Drop the mirror (the capacity tier: once an exact-code sidecar
        serves the scan, the mirror is dead device memory).  The host
        tier stays the master; a later flush_device() mirrors everything
        again.  A no-op on the disk tier, which holds none."""
        if self.tier == "disk":
            return
        with self._lock:
            self.device = torch.zeros((8, self.d), dtype=self.device_dtype,
                                      device=self.dev)
            self.device_norms = torch.zeros((8,), dtype=torch.float32,
                                            device=self.dev)
            self._flushed = 0
            self.released = True

    def device_rows(self, start: int, end: int) -> torch.Tensor:
        """Device-resident rows [start, end) of the mirror (a view of a
        published, never-mutated tensor).  Caller ensures end <= flushed."""
        assert end <= self._flushed
        return self.device[start:end]

    def mem_bytes(self) -> int:
        host = (0 if self.store_type in ("Mmap", "Disk")
                else self._host.nbytes)
        dev = self.device.numel() * self.device.element_size()
        return int(host + dev + self.device_norms.numel() * 4)

    # ---- checkpoint (reference: io/raw_vector_io.{h,cc}) ----

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        fz = os.path.join(path, f"{self.name}.rawvec.npz")
        f = os.path.join(path, f"{self.name}.rawvec.npy")
        if self.compress_dumps:
            np.savez_compressed(fz, x=self._host[: self.n])
            other = f
        else:
            np.save(f, self._host[: self.n])
            other = fz
        if os.path.exists(other):   # no stale sibling-format checkpoint
            os.unlink(other)

    def load(self, path: str) -> int:
        fz = os.path.join(path, f"{self.name}.rawvec.npz")
        f = os.path.join(path, f"{self.name}.rawvec.npy")
        if os.path.exists(fz):
            data = np.load(fz)["x"]
        elif os.path.exists(f):
            data = np.load(f)
        else:
            return 0
        self._reset()
        self.add(data)
        self.flush_device()
        return data.shape[0]
