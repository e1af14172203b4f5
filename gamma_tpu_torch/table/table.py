"""Scalar document table.

Reference: table/table.{h,cc} — fixed-width rows (INT/LONG/FLOAT/DOUBLE
inline, STRING as a (block, offset, len) ref into a string heap) stored in
StorageManager segments, with a libcuckoo `_id`→docid map.

TPU-native split: fixed-width fields are COLUMNS (one numpy array per
field, grow-by-doubling) — columnar because the device consumes whole
columns to evaluate filters; strings live in a host-side arena; the key
map uses the native sharded-lock C++ map (gamma_tpu.native.NativeKeyMap,
the libcuckoo analog) when libgamma_host.so is built, else a Python dict.
Keys are compared by their string form (the reference's _id is bytes).
Columns of indexed numeric fields keep a device mirror for on-device
filter evaluation (see table/range_index.py).
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from gamma_tpu_torch import native
from gamma_tpu_torch.config import DataType, FIXED_WIDTH_NUMPY, FieldInfo


class _DictKeyMap:
    """Fallback key→docid map with the NativeKeyMap interface."""

    def __init__(self):
        self.m: Dict[str, int] = {}

    def put(self, key: str, docid: int) -> int:
        old = self.m.get(key, -1)
        self.m[key] = docid
        return old

    def get(self, key: str) -> int:
        return self.m.get(key, -1)

    def delete(self, key: str) -> int:
        return self.m.pop(key, -1)

    def __len__(self) -> int:
        return len(self.m)

    def dump(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.m, f)

    def load(self, path: str) -> None:
        with open(path, "rb") as f:
            self.m = pickle.load(f)


def _make_keymap():
    if native.available():
        return native.NativeKeyMap()
    return _DictKeyMap()


class StringHeap:
    """Append-only string arena (reference: storage string blocks)."""

    def __init__(self):
        self.offsets = np.zeros(1024, dtype=np.int64)   # per slot: start
        self.lengths = np.zeros(1024, dtype=np.int32)
        self.buf = bytearray()
        self.n = 0

    def _ensure(self, n: int) -> None:
        if n > self.offsets.size:
            cap = max(n, self.offsets.size * 2)
            for name, dt in (("offsets", np.int64), ("lengths", np.int32)):
                old = getattr(self, name)
                arr = np.zeros(cap, dtype=dt)
                arr[: old.size] = old
                setattr(self, name, arr)

    def put(self, slot: int, s: str) -> None:
        self._ensure(slot + 1)
        b = s.encode()
        self.offsets[slot] = len(self.buf)
        self.lengths[slot] = len(b)
        self.buf.extend(b)
        self.n = max(self.n, slot + 1)

    def get(self, slot: int) -> str:
        if slot >= self.n:
            return ""
        o, l = int(self.offsets[slot]), int(self.lengths[slot])
        return bytes(self.buf[o: o + l]).decode()

    def put_all(self, start: int, strs: List[bytes]) -> None:
        """Bulk append: one buffer extend + vectorized offset math
        (restore path; per-slot put costs a Python call per row)."""
        n = len(strs)
        if n == 0:
            return
        self._ensure(start + n)
        lens = np.asarray([len(s) for s in strs], np.int64)
        base = len(self.buf)
        self.offsets[start:start + n] = base + np.cumsum(lens) - lens
        self.lengths[start:start + n] = lens
        self.buf.extend(b"".join(strs))
        self.n = max(self.n, start + n)

    def get_all(self, n: int) -> List[str]:
        """Decode slots [0, n) in one pass (rebuild path)."""
        n = min(n, self.n)
        blob = bytes(self.buf)
        off, ln = self.offsets, self.lengths
        return [blob[off[i]: off[i] + ln[i]].decode() for i in range(n)]

    def mem_bytes(self) -> int:
        return len(self.buf) + self.offsets.nbytes + self.lengths.nbytes


class Table:
    """Columnar scalar store + key→docid map."""

    def __init__(self, fields: List[FieldInfo], init_cap: int = 8192):
        self.fields = {f.name: f for f in fields}
        self._lock = threading.Lock()
        self.cap = init_cap
        self.n = 0          # max_docid (monotone; deletes leave holes)
        self.columns: Dict[str, np.ndarray] = {}
        self.heaps: Dict[str, StringHeap] = {}
        for f in fields:
            if f.data_type == DataType.STRING:
                self.heaps[f.name] = StringHeap()
            else:
                self.columns[f.name] = np.zeros(
                    init_cap, dtype=FIXED_WIDTH_NUMPY[f.data_type])
        self.keymap = _make_keymap()
        self.doc_keys: List[Any] = []
        self._dirty: List[int] = []   # docids updated in place
        self.native_store = None      # see attach_native()

    def _grow(self, need: int) -> None:
        if need <= self.cap:
            return
        cap = self.cap
        while cap < need:
            cap *= 2
        for name, col in self.columns.items():
            grown = np.zeros(cap, dtype=col.dtype)
            grown[: self.n] = col[: self.n]
            self.columns[name] = grown
        self.cap = cap

    # ---- CRUD (reference: table.cc Add:268-314, GetDocIDByKey:229-247) ----

    def add(self, key: Any, fields: Dict[str, Any]) -> int:
        """Append a doc; returns its docid.  Caller checks key duplicates
        beforehand (engine does upsert logic)."""
        with self._lock:
            docid = self.n
            self._grow(docid + 1)
            for name, f in self.fields.items():
                v = fields.get(name)
                if f.data_type == DataType.STRING:
                    self.heaps[name].put(docid, "" if v is None else str(v))
                else:
                    self.columns[name][docid] = (
                        0 if v is None else v)
            self.keymap.put(str(key), docid)
            self.doc_keys.append(key)
            self.n = docid + 1
            return docid

    def update(self, docid: int, fields: Dict[str, Any]) -> None:
        with self._lock:
            for name, v in fields.items():
                f = self.fields.get(name)
                if f is None:
                    continue
                if f.data_type == DataType.STRING:
                    self.heaps[name].put(docid, str(v))
                else:
                    self.columns[name][docid] = v
            self._dirty.append(docid)

    def take_dirty(self) -> List[int]:
        with self._lock:
            dirty, self._dirty = self._dirty, []
            return dirty

    # ---- incremental native persistence (reference: StorageManager
    # segments + AsyncWriter; storage/storage_manager.h:57-120) ----

    def attach_native(self, directory: str, compress: bool = False) -> None:
        from gamma_tpu_torch.storage.native_backend import ColumnStore
        self.native_store = ColumnStore(directory,
                                        list(self.fields.values()),
                                        compress=compress)

    def flush_storage(self, dirty: Optional[List[int]] = None) -> int:
        if self.native_store is None:
            return 0
        with self._lock:
            return self.native_store.flush(self, dirty)

    def sync_storage(self) -> None:
        if self.native_store is not None:
            self.native_store.sync()

    def load_native(self, n: int) -> int:
        """Restore rows from the native segments (truncating to n)."""
        if self.native_store is None:
            return 0
        self.native_store.truncate(min(n, self.native_store.persisted()))
        return self.native_store.load_into(self, n)

    def close_storage(self) -> None:
        if self.native_store is not None:
            self.native_store.close()
            self.native_store = None

    def docid_by_key(self, key: Any) -> int:
        return self.keymap.get(str(key))

    def key_count(self) -> int:
        return len(self.keymap)

    def key_by_docid(self, docid: int) -> Any:
        if 0 <= docid < len(self.doc_keys):
            return self.doc_keys[docid]
        return None

    def delete_key(self, key: Any) -> int:
        with self._lock:
            return self.keymap.delete(str(key))

    def get_doc(self, docid: int,
                field_names: Optional[List[str]] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        names = field_names or list(self.fields)
        for name in names:
            f = self.fields.get(name)
            if f is None:
                continue
            if f.data_type == DataType.STRING:
                out[name] = self.heaps[name].get(docid)
            else:
                out[name] = self.columns[name][docid].item()
        return out

    def column(self, name: str) -> np.ndarray:
        return self.columns[name][: self.n]

    def mem_bytes(self) -> int:
        m = sum(c.nbytes for c in self.columns.values())
        m += sum(h.mem_bytes() for h in self.heaps.values())
        return int(m)

    # ---- checkpoint (reference: table dump via StorageManager::Sync) ----

    def dump(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        state = {
            "n": self.n,
            "columns": {k: v[: self.n] for k, v in self.columns.items()},
            "heaps": {k: (bytes(h.buf), h.offsets[: h.n].copy(),
                          h.lengths[: h.n].copy())
                      for k, h in self.heaps.items()},
            "doc_keys": self.doc_keys,
        }
        with open(os.path.join(path, "table.pkl"), "wb") as f:
            pickle.dump(state, f)
        self.keymap.dump(os.path.join(path, "table.keys"))

    def load(self, path: str, doc_num: Optional[int] = None) -> int:
        fp = os.path.join(path, "table.pkl")
        if not os.path.exists(fp):
            return 0
        with open(fp, "rb") as f:
            state = pickle.load(f)
        n = state["n"] if doc_num is None else min(doc_num, state["n"])
        # grow BEFORE publishing n: _grow copies self.n old rows, and a
        # checkpoint larger than the current capacity would otherwise
        # broadcast-error
        self._grow(max(n, 1))
        self.n = n
        for k, v in state["columns"].items():
            self.columns[k][: n] = v[: n]
        for k, (buf, offs, lens) in state["heaps"].items():
            h = StringHeap()
            h.buf = bytearray(buf)
            h._ensure(len(offs))
            h.offsets[: len(offs)] = offs
            h.lengths[: len(lens)] = lens
            h.n = len(offs)
            self.heaps[k] = h
        self.doc_keys = state["doc_keys"][: n]
        self.keymap = _make_keymap()
        kp = os.path.join(path, "table.keys")
        if os.path.exists(kp):
            self.keymap.load(kp)
            # load-truncate consistency: drop keys beyond the doc count
            for d in range(n, state["n"]):
                if d < len(state["doc_keys"]):
                    self.keymap.delete(str(state["doc_keys"][d]))
        return n
