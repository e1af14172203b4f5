"""VectorManager: per-field raw stores + per-(field, model) indexes
(counterpart of gamma_tpu/vector/vector_manager.py).

Reference: vector/vector_manager.{h,cc} — creates RawVectors and
RetrievalModels from TableInfo (CreateVectorTable:34-201), pumps new /
updated vectors into indexes in batches (AddRTVecsToIndex:280-382,
batch=1000, ≤20000 updates/cycle), dispatches multi-vector-query searches
and merges by docid (Search:433-617).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from gamma_tpu_torch.config import SearchParams, TableInfo, VectorInfo
from gamma_tpu_torch.index import create_model
from gamma_tpu_torch.index.model import RetrievalModel
from gamma_tpu_torch.utils.device import resolve_device
from gamma_tpu_torch.vector.raw_store import RawVectorStore

RT_BATCH = 8192          # indexer pump batch (reference uses 1000 on CPU;
                         # TPU amortizes launches better with bigger steps)
MAX_UPDATES_PER_CYCLE = 20000   # reference: vector_manager.cc:366


class VectorManager:
    def __init__(self, root_path: str = "", device=None):
        self.root_path = root_path
        # every store and index it creates lives there (default: the card)
        self.device = resolve_device(device, "VectorManager")
        self.stores: Dict[str, RawVectorStore] = {}
        # index name "<field>_<model>" → model  (reference keys the same way)
        self.indexes: Dict[str, RetrievalModel] = {}
        self._lock = threading.Lock()
        # one pump at a time: the background indexer's flush() and a
        # caller's would otherwise both post the vids from the same
        # indexed_count.  Searches never take it (they read published
        # snapshots)
        self._pump_lock = threading.Lock()
        # pending update queue: (field, vid, docid) — drained by the pump
        self._updated: List[Tuple[str, int, int]] = []

    # ---- creation (reference: CreateVectorTable, vector_manager.cc:34) ----

    def create_vector_table(self, table: TableInfo,
                            persist_dir: Optional[str] = None) -> None:
        # fp8 = the in-memory compression tier of the device mirror;
        # host_dtype=float16 halves the host store; compress "zstd" →
        # native zstd block compression of the persisted segments, any
        # other truthy value → zlib-compressed whole-corpus checkpoints
        dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float8": torch.float8_e4m3fn,
                  "float8_e4m3": torch.float8_e4m3fn}
        for vi in table.vectors:
            dd = str(vi.store_param.get("device_dtype", "bfloat16"))
            hd = str(vi.store_param.get("host_dtype", "float32"))
            comp = vi.store_param.get("compress", False)
            store = RawVectorStore(
                vi.name, vi.dimension,
                store_type=vi.store_type,
                device_dtype=dtypes.get(dd, torch.bfloat16),
                host_dtype=(np.float16 if hd in ("float16", "f16")
                            else np.float32),
                root_path=os.path.join(self.root_path, "vectors"),
                compress_dumps=bool(comp) and comp != "zstd",
                compress_blocks=comp == "zstd",
                device=self.device,
            )
            if persist_dir is not None:
                store.attach_persist(persist_dir)
            self.stores[vi.name] = store
            if not vi.is_index:
                continue
            for i, rt_name in enumerate(table.retrieval_types):
                if (store.tier == "disk" and rt_name.upper() not in
                        ("IVFPQ", "IVFPQ_FASTSCAN", "VEARCH", "SCANN")):
                    raise ValueError(
                        f"store_type=RocksDB/Disk supports the IVFPQ "
                        f"family only (codes on the card + read-through "
                        f"rerank); got {rt_name}")
                params = (table.retrieval_params[i]
                          if i < len(table.retrieval_params) else {})
                model = create_model(rt_name, store, params)
                # field recorded ON the model: parsing it back out of the
                # dict key is ambiguous for model names with underscores
                model.field = vi.name
                self.indexes[f"{vi.name}_{rt_name.upper()}"] = model

    def index_for(self, field: str, model_name: Optional[str] = None
                  ) -> Optional[RetrievalModel]:
        if model_name:
            return self.indexes.get(f"{field}_{model_name.upper()}")
        for m in self.indexes.values():
            if m.field == field:
                return m
        return None

    # ---- ingest ----

    def add_to_store(self, field: str, rows: np.ndarray,
                     docid: int) -> np.ndarray:
        store = self.stores[field]
        vids = store.add(rows)
        multi = rows.ndim == 2 and rows.shape[0] > 1
        if multi and not store.vid_mgr.multi:
            store.vid_mgr.multi = True
        store.vid_mgr.note(docid, vids)
        return vids

    def queue_update(self, field: str, vid: int, docid: int) -> None:
        with self._lock:
            self._updated.append((field, vid, docid))

    # ---- indexer pump (reference: AddRTVecsToIndex) ----

    def add_rt_vecs_to_index(self) -> int:
        """Move stored-but-unindexed vectors into every trained index, in
        RT_BATCH chunks; then drain the update queue.  Returns vectors
        pumped.  One critical section per manager (`_pump_lock`), so two
        callers never post the same vids."""
        with self._pump_lock:
            return self._pump()

    def _pump(self) -> int:
        moved = 0
        for model in self.indexes.values():
            if not model.trained():
                continue
            store = self.stores[model.field]
            while model.indexed_count < store.n:
                start = model.indexed_count
                end = min(start + RT_BATCH, store.n)
                # prefer the already-uploaded device mirror (bf16) so the
                # pump never re-ships vectors over the host link
                rows = (store.device_rows(start, end)
                        if end <= store.flushed
                        else store.header(start, end))
                vids = np.arange(start, end, dtype=np.int64)
                docids = store.vid_mgr.vid2doc(vids)
                with model.mutate_lock:
                    model.add(rows, vids, docids)
                moved += end - start
        # updates: tombstone + re-add (reference: Update drain :340-366)
        with self._lock:
            updates, self._updated = (self._updated[:MAX_UPDATES_PER_CYCLE],
                                      self._updated[MAX_UPDATES_PER_CYCLE:])
        if updates:
            by_field: Dict[str, List[Tuple[int, int]]] = {}
            for field, vid, docid in updates:
                by_field.setdefault(field, []).append((vid, docid))
            for field, pairs in by_field.items():
                vids = np.array([p[0] for p in pairs], dtype=np.int64)
                docids = np.array([p[1] for p in pairs], dtype=np.int64)
                rows = self.stores[field].get(vids)
                for model in self.indexes.values():
                    if model.field == field and model.trained():
                        # only re-add vids already indexed
                        sel = vids < model.indexed_count
                        if sel.any():
                            with model.mutate_lock:
                                model.update(vids[sel], rows[sel],
                                             docids[sel])
        return moved

    def min_indexed_num(self) -> int:
        counts = [m.indexed_count for m in self.indexes.values()]
        return min(counts) if counts else 0

    def delete(self, field_vids: Dict[str, np.ndarray]) -> None:
        for field, vids in field_vids.items():
            for model in self.indexes.values():
                if model.field == field:
                    with model.mutate_lock:
                        model.delete(vids)

    def compact_if_needed(self) -> None:
        # under the pump's rule: slots move, so no pump posts beside it
        with self._pump_lock:
            for m in self.indexes.values():
                with m.mutate_lock:
                    m.compact()

    # ---- persistence (reference: Dump/Load vector_manager.cc:731-804) ----

    def dump(self, path: str) -> None:
        for store in self.stores.values():
            store.dump(path)
        for m in self.indexes.values():
            m.dump(path)

    def load(self, path: str) -> int:
        """Returns the min vector count across fields (load-truncate
        consistency, reference: vector_manager.cc:761-804)."""
        counts = []
        for store in self.stores.values():
            counts.append(store.load(path))
        for m in self.indexes.values():
            m.load(path)
        return min(counts) if counts else 0

    # ---- incremental native persistence ----

    def flush_storage(self) -> None:
        for store in self.stores.values():
            store.flush_storage()

    def sync_storage(self) -> None:
        for store in self.stores.values():
            store.sync_storage()

    def load_persist(self, limits: Dict[str, int], index_dir: str) -> int:
        """Restore raw vectors from native segments + indexes from the
        committed index dump.  Returns min vector count."""
        counts = []
        for name, store in self.stores.items():
            counts.append(store.load_persist(limits.get(name, 0)))
        for m in self.indexes.values():
            m.load(index_dir)
        return min(counts) if counts else 0

    def close_storage(self) -> None:
        for store in self.stores.values():
            store.close_persist()

    def mem_bytes(self) -> Tuple[int, int]:
        v = sum(s.mem_bytes() for s in self.stores.values())
        i = sum(m.mem_bytes() for m in self.indexes.values())
        return int(v), int(i)
