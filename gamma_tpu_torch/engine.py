"""GammaEngine — the orchestrator (counterpart of gamma_tpu/engine.py).

Reference: search/gamma_engine.{h,cc} (Setup:233-297, CreateTable:524-617,
AddOrUpdateDocs:676-759, Search:299-469, BuildIndex/Indexing:996-1043,
Dump:1101-1146, Load:1175-1285, DelDocByQuery:..., GetEngineStatus:1071).

Threading model (vs the reference's 4 threads):
  * callers ingest on any thread (host locks on the table/store/maps);
  * device state flushes happen in `flush()` — either called explicitly
    or by the background indexer thread (the analog of gamma's 1 Hz
    Indexing loop, gamma_engine.cc:996-1043);
  * searches run against immutable device-state snapshots, so they never
    block on, or are corrupted by, concurrent ingest — the functional
    re-statement of gamma's lock-free realtime design;
  * a semaphore caps concurrent device search batches
    (RequestConcurrentController analog, gamma_engine.cc:43-115).

Device state is published copy-on-write (every update builds a new
tensor), so a search never sees a half-applied ingest.  A vector field
with store_type "Disk" / "RocksDB" (the disk tier) holds no device
mirror: its brute-force search streams the host rows through the card,
its IVFPQ-family models rerank rows read through the store's row-block
LRU, sized by `vector_cache_mb` and resized by `set_vector_cache_mb`.
Multi-device serving (enable_sharded_search) is not ported yet
(ROADMAP.md A, multi-device).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gamma_tpu_torch.api.doc import Doc
from gamma_tpu_torch.api.request import Request, VectorQuery
from gamma_tpu_torch.api.response import (Response, ResultItem, SearchResult,
                                    SearchResultCode)
from gamma_tpu_torch.api.status import EngineStatus, IndexStatus
from gamma_tpu_torch.config import (DataType, EngineConfig, MetricType,
                              SearchParams, TableInfo)
from gamma_tpu_torch.ops import penalty as pen_ops
from gamma_tpu_torch.ops.distances import BIG
from gamma_tpu_torch.ops.flat_scan import flat_search, flat_search_streaming
from gamma_tpu_torch.storage.migrate import MigrateData
from gamma_tpu_torch.table.range_index import MultiFieldsRangeIndex
from gamma_tpu_torch.table.table import Table
from gamma_tpu_torch.utils.bitmap import BitmapManager
from gamma_tpu_torch.utils.device import resolve_device
from gamma_tpu_torch.utils.fileio import atomic_write_json, read_json
from gamma_tpu_torch.utils.perf import PerfTool
from gamma_tpu_torch.vector.vector_manager import VectorManager

ROW_PAD = 4096           # device row padding quantum for penalty arrays


class GammaEngine:
    def __init__(self, config: EngineConfig, device=None):
        """`device`: where the index, mirrors and penalties live (default:
        the current CUDA device).  Without a CUDA device the caller must
        ask for the CPU (`device="cpu"`): the engine never falls back to
        it on its own."""
        self.config = config
        self.device = resolve_device(device, "GammaEngine")
        os.makedirs(config.path, exist_ok=True)
        from gamma_tpu_torch.utils.log import configure as _configure_log
        self.log = _configure_log(config.log_dir)
        self.log.info("engine init path=%s", config.path)
        self.table: Optional[Table] = None
        self.table_info: Optional[TableInfo] = None
        self.vm = VectorManager(config.path, device=self.device)
        # incremental persistence over native segments when available
        # (reference: StorageManager + AsyncWriter — dump == sync+marker)
        from gamma_tpu_torch import native as _native
        self._native_persist = bool(config.native_persistence
                                    and _native.available())
        self.range_index: Optional[MultiFieldsRangeIndex] = None
        self.bitmap = BitmapManager()
        # load=True: an existing bitmap file must survive restart —
        # deleted docs resurrect otherwise (reference loads before any
        # write: gamma_engine.cc:253-271, bitmap_manager.cc:96-158)
        self.bitmap.open_file(os.path.join(config.path, "bitmap.dat"),
                              load=True)
        self.delete_num = self.bitmap.set_count
        self.max_docid = 0

        # device validity (penalty form): grown/updated at flush.  The
        # version stamps batcher coalescing keys: two requests may share
        # a device batch iff they saw the same validity snapshot
        self._validity = pen_ops.init_validity(ROW_PAD, self.device)
        self._validity_version = 0
        self._device_rows = ROW_PAD
        self._live_flushed = 0                # docids < this are marked live
        self._pending_dead: List[int] = []

        self._ingest_lock = threading.Lock()
        # derived admission width when unset (reference:
        # RequestConcurrentController::GetMaxThread, gamma_engine.cc:74-97).
        # Wide by default: the batch aggregator serializes device work
        # itself, and its coalesce width is capped by how many callers
        # can be in flight.
        mc = config.max_concurrent
        if mc <= 0:
            mc = max(16, min(128, 2 * (os.cpu_count() or 8)))
        self.max_concurrent = mc
        self._search_sem = threading.Semaphore(mc)
        # cross-request batch aggregation (reference: the GPU path's
        # dedicated search thread, gpu.cc:52,557-640): concurrent callers
        # coalesce into one device batch instead of serializing
        from gamma_tpu_torch.batcher import BatchAggregator
        self._batcher: Optional[BatchAggregator] = BatchAggregator()
        self._index_status = IndexStatus.UNINDEXED
        self._indexer_thread: Optional[threading.Thread] = None
        self._indexer_stop = threading.Event()
        self._training = False
        self.migrate: Optional[MigrateData] = None

    # ================= table lifecycle =================

    def create_table(self, info: TableInfo) -> int:
        self.table_info = info
        self.table = Table(info.fields)
        persist_dir = None
        if self._native_persist:
            persist_dir = os.path.join(self.config.path, "store")
            self.table.attach_native(
                persist_dir,
                compress=bool(getattr(self.config,
                                      "compress_table_blocks", False)))
        self.vm.create_vector_table(info, persist_dir=persist_dir)
        for store in self.vm.stores.values():
            store.set_cache_bytes(self.config.vector_cache_mb << 20)
        self.range_index = MultiFieldsRangeIndex(self.table, self.device)
        for f in info.fields:
            if f.is_index:
                self.range_index.add_field(f.name, f.data_type)
        self.log.info("create_table %s: %d fields, %d vector fields",
                      info.name, len(info.fields), len(info.vectors))
        # persist schema (reference: TableSchemaIO, gamma_engine.cc:607-612)
        atomic_write_json(
            os.path.join(self.config.path, f"{info.name}.schema"),
            json.loads(info.to_json()))
        return 0

    def create_table_from_local(self) -> Optional[str]:
        for fn in os.listdir(self.config.path):
            if fn.endswith(".schema"):
                info = TableInfo.from_json(
                    json.dumps(read_json(os.path.join(self.config.path, fn))))
                self.create_table(info)
                return info.name
        return None

    # ================= ingest =================

    def add_or_update_doc(self, doc: Doc) -> int:
        return self.add_or_update_docs([doc])[0]

    def add_or_update_docs(self, docs: Sequence[Doc]) -> List[int]:
        """Upsert a batch (reference: AddOrUpdateDocs gamma_engine.cc:676).
        Returns one status code per doc (0 = ok)."""
        codes = []
        with self._ingest_lock:
            for doc in docs:
                codes.append(self._add_or_update_one(doc))
        # auto-train trigger (reference: :744-749)
        if (self.table is not None
                and self.table.n >= self.table_info.indexing_size
                and self._index_status == IndexStatus.UNINDEXED):
            self.build_index()
        return codes

    def _add_or_update_one(self, doc: Doc) -> int:
        table = self.table
        existing = table.docid_by_key(doc.key)
        # existing >= table.n guards against stale keymap entries (a
        # crash can leave table.keys newer than the committed doc count)
        if 0 <= existing < table.n and not self.bitmap.test(existing):
            return self._update_doc(existing, doc)
        # validate BEFORE any mutation: a mid-loop bail-out after
        # table.add/store.add would leave the stores' vid<->docid
        # alignment permanently skewed
        if any(name not in doc.vectors for name in self.vm.stores):
            return 1   # every vector field is required (as reference)
        docid = table.add(doc.key, doc.fields)
        self.range_index.add_doc(docid, doc.fields)
        for name, store in self.vm.stores.items():
            rows = np.asarray(doc.vectors[name], np.float32).reshape(-1,
                                                                     store.d)
            self.vm.add_to_store(name, rows, docid)
        self.max_docid = table.n
        if self.migrate is not None:
            self.migrate.add_doc(docid)
        return 0

    def _update_doc(self, docid: int, doc: Doc) -> int:
        # re-index terms BEFORE the table write (needs the old values to
        # drop the doc from its previous terms' postings)
        self.range_index.update_doc(docid, doc.fields)
        self.table.update(docid, doc.fields)
        # attribute updates change which docs match range/term filters:
        # bump the validity version so the batch aggregator never
        # coalesces requests straddling this update onto one stale
        # penalty snapshot
        self._validity_version += 1
        for name, vecs in doc.vectors.items():
            store = self.vm.stores.get(name)
            if store is None:
                continue
            # update EVERY vid of the doc's field (reference re-adds all
            # of a doc's vectors on update) — writing only rows[:1] left
            # vectors 2..n stale in store, mirror, and index
            vids = store.vid_mgr.doc_vids(docid)
            rows = np.asarray(vecs, np.float32).reshape(-1, store.d)
            m = min(vids.size, rows.shape[0])
            if m == 0:
                continue
            store.update(vids[:m], rows[:m])
            for vid in vids[:m]:
                self.vm.queue_update(name, int(vid), docid)
        if self.migrate is not None:
            self.migrate.update_doc(docid)
        return 0

    def delete(self, key: Any) -> int:
        with self._ingest_lock:
            docid = self.table.delete_key(key)
            if (docid < 0 or docid >= self.table.n
                    or self.bitmap.test(docid)):
                return -1
            self.bitmap.set(docid)
            self.delete_num += 1
            # immediate device mask if the row is already live on device
            if docid < self._live_flushed:
                self._validity = pen_ops.mark_deleted(
                    self._validity, torch.tensor([docid]))
                self._validity_version += 1
            else:
                self._pending_dead.append(docid)
            field_vids = {}
            for name, store in self.vm.stores.items():
                # tombstone EVERY vid of the doc — the unfiltered
                # validity scan path has no doc-space penalty to catch
                # a deleted doc's 2nd..nth vectors otherwise
                field_vids[name] = store.vid_mgr.doc_vids(docid)
            self.vm.delete(field_vids)
            self.range_index.delete_doc(docid)
            if self.migrate is not None:
                self.migrate.delete_doc(docid)
            return 0

    def del_doc_by_query(self, request: Request) -> int:
        """Delete every doc matching the request's range AND term filters
        (reference: GammaEngine::DelDocByQuery routes through
        MultiFieldsRangeIndex::Search, field_range_index.cc:1015-1115).
        Matching runs against the filter index — device column mirrors +
        term postings — not a host column scan (an O(N) f64 host pass
        crawls at 10M rows); the incremental mirror flush first gives
        read-your-writes freshness."""
        if not request.range_filters and not request.term_filters:
            return 0
        self.range_index.flush_device()
        docids = self.range_index.matching_docids(
            request.range_filters, request.term_filters, self.table.n)
        deleted = 0
        for docid in docids:
            key = self.table.key_by_docid(int(docid))
            if key is not None and self.delete(key) == 0:
                deleted += 1
        return deleted

    # ================= flush / index pump =================

    def flush(self) -> None:
        """Push pending host state to device: raw vectors, field columns,
        validity; then pump the realtime indexes.  The engine-level analog
        of gamma's async hops (AsyncWriter + field worker + indexer)."""
        with self._ingest_lock:
            n = self.table.n if self.table else 0
            rows = max(ROW_PAD, -(-max(n, 1) // ROW_PAD) * ROW_PAD)
            if rows > self._device_rows:
                self._validity = torch.nn.functional.pad(
                    self._validity, (0, rows - self._device_rows),
                    value=BIG)
                self._device_rows = rows
            if n > self._live_flushed:
                new = torch.arange(self._live_flushed, n)
                self._validity = pen_ops.mark_live(self._validity, new)
                self._validity_version += 1
                self._live_flushed = n
            if self._pending_dead:
                self._validity_version += 1
                self._validity = pen_ops.mark_deleted(
                    self._validity,
                    torch.tensor(self._pending_dead, dtype=torch.int64))
                self._pending_dead.clear()
            for store in self.vm.stores.values():
                store.flush_device()
            dirty = self.table.take_dirty()
            self.table.flush_storage(dirty)      # no-op without native
            self.vm.flush_storage()
            self.range_index.flush_device(pad_chunk=ROW_PAD, dirty=dirty)
        self.vm.add_rt_vecs_to_index()
        self.vm.compact_if_needed()

    # ================= training =================

    def build_index(self) -> int:
        """Train all untrained indexes, then pump (reference: BuildIndex
        spawns the Indexing thread, gamma_engine.cc:996-1043).  Synchronous
        here; start_background_indexer() gives the 1 Hz loop."""
        if self._training:
            return 0
        self._training = True
        try:
            self._index_status = IndexStatus.INDEXING
            for key, model in self.vm.indexes.items():
                if model.trained():
                    continue
                field = model.field
                store = self.vm.stores[field]
                n_train = min(store.n, self.table_info.indexing_size
                              or store.n)
                if n_train == 0:
                    continue
                model.train(store.header(0, n_train))
            self.flush()
            self._index_status = IndexStatus.INDEXED
            self.log.info("build_index done; indexed=%d",
                          self.vm.min_indexed_num())
        finally:
            self._training = False
        return 0

    def start_background_indexer(self, interval_s: float = 1.0) -> None:
        if self._indexer_thread is not None:
            return
        self._indexer_stop.clear()

        def loop():
            while not self._indexer_stop.wait(interval_s):
                try:
                    self.flush()
                except Exception:    # pragma: no cover - keep loop alive
                    pass

        self._indexer_thread = threading.Thread(target=loop, daemon=True)
        self._indexer_thread.start()

    def stop_background_indexer(self) -> None:
        if self._indexer_thread is not None:
            self._indexer_stop.set()
            self._indexer_thread.join()
            self._indexer_thread = None

    # ================= search =================

    def _compose_penalty(self, request: Request) -> torch.Tensor:
        parts = [self._validity]

        def fit(p: torch.Tensor) -> torch.Tensor:
            if p.shape[0] == self._device_rows:
                return p
            # mirror lag; pad/truncate defensively
            return torch.nn.functional.pad(
                p[: self._device_rows],
                (0, max(0, self._device_rows - p.shape[0])), value=BIG)

        if request.range_filters:
            for p in self.range_index.range_penalties(
                    request.range_filters):
                parts.append(fit(p))
        if request.term_filters:
            # device masks maintained at flush time — no O(N) host mask
            # build or upload on the query path (reference: async
            # field-index worker, field_range_index.cc:901-989)
            for p in self.range_index.term_penalties(request.term_filters):
                parts.append(fit(p))
        return pen_ops.combine(parts)

    def _penalty_for_store(self, pen_doc: torch.Tensor,
                           store) -> torch.Tensor:
        """Row-aligned penalty for flat scans over a store's rows: its
        device mirror, or on the disk tier (no mirror) its host rows."""
        cap = store.n if store.tier == "disk" else store.device.shape[0]
        if store.vid_mgr.multi:
            v2d = np.full(cap, -1, dtype=np.int64)
            src = store.vid_mgr._vid2doc
            m = min(cap, src.size)
            v2d[:m] = src[:m]
            idx = torch.from_numpy(v2d).to(pen_doc.device)
            ok = (idx >= 0) & (idx < pen_doc.shape[0])
            got = pen_doc[idx.clamp(0, pen_doc.shape[0] - 1)]
            return torch.where(ok, got, BIG)
        if cap <= self._device_rows:
            return pen_doc[:cap]
        return torch.nn.functional.pad(pen_doc, (0, cap - self._device_rows),
                                       value=BIG)

    def search(self, request: Request) -> Response:
        perf = PerfTool(request.online_log_level == "debug")
        resp = Response()
        if self.table is None or not request.vec_fields:
            resp.results.append(SearchResult(
                result_code=SearchResultCode.SEARCH_ERROR,
                msg="no table or no vector query"))
            return resp
        # validate filter fields up front (reference returns an error for
        # filters on unindexed fields rather than silently ignoring them)
        for rf in request.range_filters:
            if rf.field not in self.range_index.numeric_fields:
                resp.results.append(SearchResult(
                    result_code=SearchResultCode.SEARCH_ERROR,
                    msg=f"range filter on unindexed field {rf.field!r}"))
                return resp
        for tf in request.term_filters:
            if tf.field not in self.range_index.term_fields:
                resp.results.append(SearchResult(
                    result_code=SearchResultCode.SEARCH_ERROR,
                    msg=f"term filter on unindexed field {tf.field!r}"))
                return resp
        with self._search_sem:     # admission control
            sp = SearchParams.from_dict(request.retrieval_params)
            pen_doc = self._compose_penalty(request)
            perf.perf("filter")

            per_field: List[Tuple[VectorQuery, np.ndarray, np.ndarray]] = []
            req_num = 0
            for vq in request.vec_fields:
                dists, docids = self._search_one_field(
                    vq, request, sp, pen_doc)
                req_num = dists.shape[0]
                per_field.append((vq, dists, docids))
                perf.perf(f"scan:{vq.name}")

            merged = self._merge_fields(per_field, request)
            perf.perf("merge")

            metric = self._result_metric(sp)
            # batch the post-processing: one bitmap test, one score
            # transform, and one column fancy-index per field for the
            # WHOLE result set — per-hit Python (get_doc dict per item)
            # was ~70 ms for a 512x10 response (reference packs per hit
            # too, gamma_response.cc:217, but in C++)
            l2s = bool(request.l2_sqrt or sp.l2_sqrt)
            want = request.fields or []
            tf = self.table.fields
            num_fields = [f for f in want
                          if f in tf and tf[f].data_type != DataType.STRING]
            str_fields = [f for f in want
                          if f in tf and tf[f].data_type == DataType.STRING]
            vec_names = [f for f in want if f in self.vm.stores]
            flat_rows: List[int] = []
            flat_ids: List[int] = []
            flat_dists: List[float] = []
            for b in range(len(merged)):
                for dist, docid in merged[b]:
                    if docid < 0 or dist >= BIG:
                        continue
                    flat_rows.append(b)
                    flat_ids.append(int(docid))
                    flat_dists.append(float(dist))
            ids_arr = np.asarray(flat_ids, np.int64)
            if ids_arr.size:
                dead = self.bitmap.test_many(ids_arr)
                darr = np.asarray(flat_dists)
                if metric == "ip":
                    scores = -darr
                elif l2s:
                    scores = np.sqrt(np.maximum(darr, 0.0))
                else:
                    scores = darr
                num_vals = {f: self.table.columns[f][ids_arr]
                            for f in num_fields}
            else:
                dead = np.zeros(0, bool)
                scores = np.zeros(0)
                num_vals = {}
            out_srs = [SearchResult() for _ in merged]
            keys = self.table.doc_keys
            heaps = self.table.heaps
            topn = request.topn
            for j in range(ids_arr.size):
                if dead[j]:
                    continue
                sr = out_srs[flat_rows[j]]
                if len(sr.result_items) >= topn:
                    continue
                docid = flat_ids[j]
                item = ResultItem(
                    score=float(scores[j]), docid=docid,
                    key=keys[docid] if 0 <= docid < len(keys) else None)
                if want:
                    attrs = {f: v[j].item() for f, v in num_vals.items()}
                    for f in str_fields:
                        attrs[f] = heaps[f].get(docid)
                    for f in vec_names:
                        store = self.vm.stores[f]
                        vid = store.vid_mgr.doc2vid(docid)
                        if 0 <= vid < store.n:
                            attrs[f] = store.get(np.array([vid]))[0]
                    item.attributes = attrs
                sr.result_items.append(item)
            for sr in out_srs:
                sr.total = len(sr.result_items)
                resp.results.append(sr)
            perf.perf("pack")
        resp.online_log_message = perf.output()
        return resp

    def _result_metric(self, sp: SearchParams) -> str:
        mt = sp.metric_type
        if mt is None and self.table_info.retrieval_params:
            mt_s = str(self.table_info.retrieval_params[0].get(
                "metric_type", "L2")).upper()
            mt = (MetricType.INNER_PRODUCT
                  if mt_s in ("IP", "INNERPRODUCT", "INNER_PRODUCT")
                  else MetricType.L2)
        return "ip" if mt == MetricType.INNER_PRODUCT else "l2"

    def _dist_range(self, vq: VectorQuery, sp: SearchParams,
                    l2_sqrt: bool) -> Optional[torch.Tensor]:
        """Map the request's score range into DISTANCE space for in-scan
        fusion (reference: IsSimilarScoreValid is checked inside the
        scanner, gamma_index_ivfpq.h:574-601)."""
        if vq.min_score == -np.inf and vq.max_score == np.inf:
            return None
        metric = self._result_metric(sp)
        if metric == "ip":
            lo = -vq.max_score if vq.max_score < np.inf else -BIG
            hi = -vq.min_score if vq.min_score > -np.inf else BIG
        else:
            lo = max(vq.min_score, 0.0) if vq.min_score > -np.inf else 0.0
            hi = vq.max_score if vq.max_score < np.inf else BIG
            if l2_sqrt:        # reported score = sqrt(dist)
                lo, hi = lo * lo, min(hi, 1e19) * min(hi, 1e19)
        lo = float(np.clip(lo, -BIG, BIG))
        hi = float(np.clip(hi, -BIG, BIG))
        return torch.tensor([lo, hi], dtype=torch.float32,
                            device=self.device)

    def _exec_field_search(self, store, model, q: np.ndarray,
                           sp: SearchParams, k: int, pen_doc: torch.Tensor,
                           dist_range, brute: bool, validity_n=None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Direct device execution of one field search over q [b, d] —
        row-independent, so the batch aggregator can stack several
        requests' queries and slice the results back."""
        qd = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(
            self.device)
        if brute or model is None:
            metric = ("ip" if self._result_metric(sp) == "ip" else "l2")
            # the scan indexes rows by vid: the doc-aligned penalty is
            # mapped into row space first (multi-vid stores)
            pen_rows = self._penalty_for_store(pen_doc, store)
            if store.tier == "disk":
                # no device mirror: stream the host corpus through the
                # card (reference: rocksdb_raw_vector.cc read-through)
                dists, rows = flat_search_streaming(
                    store.header(0, store.n), store.n, qd, pen_rows,
                    dist_range, k=k, metric=metric)
            else:
                dists, rows = flat_search(store.device, store.device_norms,
                                          qd, pen_rows, dist_range,
                                          k=k, metric=metric)
            dists_np = dists.cpu().numpy()
            rows_np = rows.cpu().numpy()
            docids_np = (store.vid_mgr.vid2doc(
                np.maximum(rows_np, 0)) if store.vid_mgr.multi else rows_np)
            docids_np = np.where(rows_np < 0, -1, docids_np)
        else:
            row_space = model.penalty_space == "row"
            pen = (self._penalty_for_store(pen_doc, store)
                   if row_space else pen_doc)
            dists, docids, vids = model.search(qd, pen, sp, k,
                                               dist_range,
                                               validity_n=validity_n)
            dists_np = dists.cpu().numpy()
            docids_np = docids.cpu().numpy()
            if row_space and store.vid_mgr.multi:
                rows_np = docids_np
                docids_np = np.where(
                    rows_np < 0, -1,
                    store.vid_mgr.vid2doc(np.maximum(rows_np, 0)))
        return dists_np, docids_np

    @staticmethod
    def _sp_key(sp: SearchParams) -> Tuple:
        return (sp.metric_type, sp.nprobe, sp.recall_num, sp.has_rank,
                sp.l2_sqrt, sp.scan_mode, sp.recall_target, sp.ef_search)

    def _search_one_field(self, vq: VectorQuery, request: Request,
                          sp: SearchParams, pen_doc: torch.Tensor
                          ) -> Tuple[np.ndarray, np.ndarray]:
        store = self.vm.stores[vq.name]
        q = np.asarray(vq.value, np.float32).reshape(-1, store.d)
        b = q.shape[0]
        k = max(request.topn, 1)
        model = self.vm.index_for(vq.name)
        dist_range = self._dist_range(vq, sp,
                                      request.l2_sqrt or sp.l2_sqrt)
        if dist_range is not None:
            # widen the model's k so the post-filter + bitmap pass still
            # leaves a full topn (the fused scans already mask in-range,
            # but non-fusing models rely on this headroom)
            k = max(k, min(max(sp.recall_num, 4 * k), 1024))

        brute = request.brute_force_search or model is None
        # unfiltered requests can skip the doc-space penalty gather
        # inside the gather-mode scans (validity is decidable from
        # the posting state + the live watermark; the gather costs
        # ~5x the ADC kernel on TPU).  Multi-vid stores keep the
        # doc-aligned penalty (vid->doc mapping happens in-scan).
        validity_n = (self._live_flushed
                      if (not request.range_filters
                          and not request.term_filters)
                      else None)
        runner = (lambda qq: self._exec_field_search(
            store, model, qq, sp, k, pen_doc, dist_range, brute,
            validity_n))
        if self._batcher is not None:
            # coalesce with concurrent compatible requests: same
            # field/params/filters over the same validity snapshot,
            # same score range.  (A fresh penalty OBJECT is composed
            # per request, so identity is the wrong key — it made
            # coalescing never fire.)
            dr_key = (None if dist_range is None
                      else (float(dist_range[0]),
                            float(dist_range[1])))
            filt_key = (
                tuple((rf.field, rf.lower_value, rf.upper_value,
                       rf.include_lower, rf.include_upper)
                      for rf in request.range_filters),
                tuple((tf.field, tuple(tf.terms()), tf.is_union)
                      for tf in request.term_filters))
            key = (vq.name, brute, k, self._validity_version,
                   filt_key, dr_key, self._sp_key(sp))
            dists_np, docids_np = self._batcher.submit(key, runner, q)
        else:
            dists_np, docids_np = runner(q)

        # score-range post-filter on the REPORTED score — authoritative
        # even where the scan fused an approximate distance range
        if vq.min_score > -np.inf or vq.max_score < np.inf:
            metric = self._result_metric(sp)
            scores = (-dists_np if metric == "ip" else dists_np)
            if metric != "ip" and (request.l2_sqrt or sp.l2_sqrt):
                scores = np.sqrt(np.maximum(scores, 0.0))
            bad = (scores < vq.min_score) | (scores > vq.max_score)
            dists_np = np.where(bad, np.float32(BIG), dists_np)
            docids_np = np.where(bad, -1, docids_np)
        if vq.has_boost:
            dists_np = dists_np * np.float32(vq.boost)
        return dists_np, docids_np

    def _merge_fields(self, per_field, request: Request):
        """Multi-vector-query docid merge (reference:
        vector_manager.cc:512-576): a doc must match every vector clause;
        its score is the (boost-weighted) sum.  Output order follows the
        reference: docid order by default, score order when the request
        sets multi_vector_rank (vector_manager.cc:562-576)."""
        nq = per_field[0][1].shape[0]
        out = []
        if len(per_field) == 1:
            _, dists, docids = per_field[0]
            for b in range(nq):
                out.append(list(zip(dists[b].tolist(), docids[b].tolist())))
            return out
        # ONE global run-reduction over all queries (lexsort by
        # (row, docid), sum/count runs with reduceat): the per-query
        # python-dict walk was O(nq * F * k) interpreter ops — at batch
        # 2048 x several vector fields the HOST became the bottleneck.
        # The only remaining per-row work is slicing the output lists.
        # Semantics identical to the dict version (docid must appear
        # len(per_field) times; summed f64 score; score order with
        # docid tie-break under multi_vector_rank, else docid order —
        # reference vector_manager.cc:562-576).
        F = len(per_field)
        docs = np.stack([np.asarray(p[2], np.int64) for p in per_field])
        dist = np.stack([np.asarray(p[1], np.float64) for p in per_field])
        live = ((docs >= 0) & (dist < BIG)).transpose(1, 0, 2).reshape(-1)
        dflat = docs.transpose(1, 0, 2).reshape(-1)[live]
        sflat = dist.transpose(1, 0, 2).reshape(-1)[live]
        bflat = np.repeat(np.arange(nq, dtype=np.int64),
                          F * docs.shape[2])[live]
        order = np.lexsort((dflat, bflat))
        bs, ds, ss = bflat[order], dflat[order], sflat[order]
        if bs.size == 0:
            return [[] for _ in range(nq)]
        new_run = np.concatenate(
            [[True], (bs[1:] != bs[:-1]) | (ds[1:] != ds[:-1])])
        starts = np.flatnonzero(new_run)
        counts = np.diff(np.append(starts, bs.size))
        sums = np.add.reduceat(ss, starts)
        keep = counts == F
        g_b, g_d, g_s = bs[starts][keep], ds[starts][keep], sums[keep]
        if request.multi_vector_rank:
            # stable by (row, score); equal scores keep docid order
            o = np.lexsort((g_s, g_b))
            g_b, g_d, g_s = g_b[o], g_d[o], g_s[o]
        row_starts = np.searchsorted(g_b, np.arange(nq))
        row_ends = np.searchsorted(g_b, np.arange(nq) + 1)
        topn = request.topn
        for s0, e0 in zip(row_starts, row_ends):
            e0 = min(e0, s0 + topn)
            out.append(list(zip(g_s[s0:e0].tolist(),
                                g_d[s0:e0].tolist())))
        return out

    # ================= point reads =================

    def get_doc_by_key(self, key: Any,
                       fields: Optional[List[str]] = None) -> Optional[Dict]:
        docid = self.table.docid_by_key(key)
        if docid < 0 or self.bitmap.test(docid):
            return None
        return self.get_doc(docid, fields)

    def get_doc(self, docid: int,
                fields: Optional[List[str]] = None) -> Optional[Dict]:
        if docid < 0 or docid >= self.table.n or self.bitmap.test(docid):
            return None
        doc = self.table.get_doc(docid, fields)
        doc["_id"] = self.table.key_by_docid(docid)
        for name, store in self.vm.stores.items():
            if fields is None or name in (fields or []):
                vid = store.vid_mgr.doc2vid(docid)
                if 0 <= vid < store.n:
                    doc[name] = store.get(np.array([vid]))[0]
        return doc

    # ================= status / config =================

    def set_max_concurrent(self, n: int) -> None:
        """Resize admission control at runtime (reference SetConfig
        semantics).  In-flight searches finish under the old semaphore;
        new searches use the new one."""
        self._search_sem = threading.Semaphore(max(1, int(n)))

    def set_vector_cache_mb(self, mb: int) -> None:
        """Resize the disk-tier row-block LRU caches at run time
        (reference: VectorManager::AlterCacheSize via SetConfig,
        gamma_engine.cc:1366-1382)."""
        self.config.vector_cache_mb = int(mb)
        for store in self.vm.stores.values():
            store.set_cache_bytes(int(mb) << 20)

    def engine_status(self) -> EngineStatus:
        vmem, imem = self.vm.mem_bytes()
        return EngineStatus(
            index_status=self._index_status,
            table_mem_bytes=self.table.mem_bytes() if self.table else 0,
            index_mem_bytes=imem,
            vector_mem_bytes=vmem,
            field_range_mem_bytes=(self.range_index.mem_bytes()
                                   if self.range_index else 0),
            bitmap_mem_bytes=self.bitmap.mem_bytes(),
            doc_count=(self.table.key_count() if self.table else 0),
            max_docid=self.max_docid,
            min_indexed_num=self.vm.min_indexed_num(),
            delete_num=self.delete_num,
        )

    # ================= checkpoint (reference: Dump/Load) =================

    def dump(self) -> int:
        """Checkpoint.  Native mode (default): the table columns, string
        heaps, and raw vectors are ALREADY on disk in mmap segments
        (appended incrementally at every flush), so dump = durable sync
        + index snapshot + atomic commit marker — O(delta), not
        O(corpus) (reference: Dump == Table::Sync + AsyncWriter::Sync +
        dump.done, gamma_engine.cc:1101-1146).  Legacy mode rewrites a
        full dump dir."""
        self.flush()
        if self._native_persist:
            return self._dump_native()
        ts = time.strftime("%Y%m%d%H%M%S") + f"_{int(time.time()*1e6)%1000000:06d}"
        dump_dir = os.path.join(self.config.path, f"dump_{ts}")
        os.makedirs(dump_dir, exist_ok=True)
        self.table.dump(dump_dir)
        self.vm.dump(dump_dir)
        self.log.info("dump -> %s (%d docs)", dump_dir, self.table.n)
        atomic_write_json(os.path.join(dump_dir, "dump.done"),
                          {"start_docid": 0, "end_docid": self.table.n})
        # retire older dumps
        for fn in sorted(os.listdir(self.config.path)):
            full = os.path.join(self.config.path, fn)
            if (fn.startswith("dump_") and full != dump_dir
                    and os.path.isdir(full)):
                shutil.rmtree(full, ignore_errors=True)
        return 0

    def _dump_native(self) -> int:
        # 1. durable barrier on the incrementally-persisted state
        self.table.sync_storage()
        self.vm.sync_storage()
        # 2. index snapshot into a fresh dir (referenced by the commit,
        #    so a crash mid-write can never corrupt the previous one)
        ts = time.strftime("%Y%m%d%H%M%S") + f"_{int(time.time()*1e6)%1000000:06d}"
        idx_dir = os.path.join(self.config.path, f"index_{ts}")
        os.makedirs(idx_dir, exist_ok=True)
        for m in self.vm.indexes.values():
            m.dump(idx_dir)
        # 3. key map + commit marker (the atomic commit point)
        self.table.keymap.dump(os.path.join(self.config.path, "table.keys"))
        commit = {
            "doc_count": self.table.n,
            "vec_counts": {name: store.n
                           for name, store in self.vm.stores.items()},
            "index_dir": os.path.basename(idx_dir),
        }
        atomic_write_json(os.path.join(self.config.path, "commit.json"),
                          commit)
        self.log.info("native dump commit: %d docs (index %s)",
                      self.table.n, os.path.basename(idx_dir))
        # 4. retire superseded index snapshots + legacy dump dirs
        for fn in sorted(os.listdir(self.config.path)):
            full = os.path.join(self.config.path, fn)
            if not os.path.isdir(full):
                continue
            if fn.startswith("index_") and full != idx_dir:
                shutil.rmtree(full, ignore_errors=True)
            elif fn.startswith("dump_"):
                shutil.rmtree(full, ignore_errors=True)
        return 0

    def _clean_partial_dumps(self) -> Optional[str]:
        """Remove legacy dump dirs without a dump.done marker; return the
        newest complete one (reference: gamma_engine.cc:1271-1276)."""
        dumps = sorted(fn for fn in os.listdir(self.config.path)
                       if fn.startswith("dump_"))
        chosen = None
        for fn in reversed(dumps):
            full = os.path.join(self.config.path, fn)
            if chosen is None and os.path.exists(
                    os.path.join(full, "dump.done")):
                chosen = full
                continue
            if not os.path.exists(os.path.join(full, "dump.done")):
                shutil.rmtree(full, ignore_errors=True)   # partial dump
        return chosen

    def load(self) -> int:
        """Restore: native commit marker when present, else the newest
        complete legacy dump; clean partials either way
        (reference: gamma_engine.cc:1175-1285)."""
        if self.table is None:
            if self.create_table_from_local() is None:
                return -1
        chosen = self._clean_partial_dumps()
        commit_path = os.path.join(self.config.path, "commit.json")
        if self._native_persist and os.path.exists(commit_path):
            commit = read_json(commit_path)
            idx_dir = os.path.join(self.config.path, commit["index_dir"])
            min_vec = self.vm.load_persist(commit["vec_counts"], idx_dir)
            doc_num = commit["doc_count"]
            doc_num = min(doc_num, min_vec) if self.vm.stores else doc_num
            self.table.load_native(doc_num)
            kp = os.path.join(self.config.path, "table.keys")
            if os.path.exists(kp):
                self.table.keymap.load(kp)
        else:
            if chosen is None:
                return 0
            min_vec = self.vm.load(chosen)
            doc_num = read_json(
                os.path.join(chosen, "dump.done"))["end_docid"]
            doc_num = min(doc_num, min_vec) if self.vm.stores else doc_num
            self.table.load(chosen, doc_num)
        self.max_docid = self.table.n
        # rebuild field range index in bulk (reference re-adds per doc,
        # gamma_engine.cc:1251-1256; this is the vectorized equivalent)
        self.range_index.rebuild(self.table)
        # deleted docs recounted from bitmap (reference :1258-1270)
        dead = np.flatnonzero(self.bitmap.as_bool_array(self.table.n))
        self.delete_num = int(dead.size)
        self._live_flushed = 0
        self._validity = pen_ops.init_validity(ROW_PAD, self.device)
        self._validity_version += 1
        self._device_rows = ROW_PAD
        self._pending_dead = dead.tolist()
        self.flush()
        if any(m.trained() for m in self.vm.indexes.values()):
            self._index_status = IndexStatus.INDEXED
        return 0

    # ================= migration (reference: gamma_api.h:194-206) ==========

    def begin_migrate(self) -> int:
        self.migrate = MigrateData(self.config.path, self.table.n)
        return 0

    def get_migrate_doc(self, batch: int = 1
                        ) -> List[Tuple[Dict, bool]]:
        """Returns up to `batch` (doc, is_delete) pairs; empty = done."""
        if self.migrate is None:
            return []
        out = []
        for docid, is_delete in self.migrate.next_batch(batch):
            if is_delete:
                out.append(({"_docid": docid}, True))
            else:
                doc = self.get_doc(docid)
                if doc is not None:
                    out.append((doc, False))
        return out

    def terminate_migrate(self) -> int:
        if self.migrate is not None:
            self.migrate.close()
            self.migrate = None
        return 0

    def close(self) -> None:
        self.stop_background_indexer()
        if self._batcher is not None:
            self._batcher.stop()
            self._batcher = None
        if self.table is not None:
            self.table.close_storage()
        self.vm.close_storage()
        self.bitmap.close()
