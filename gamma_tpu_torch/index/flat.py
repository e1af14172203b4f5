"""FLAT: exact brute-force retrieval (counterpart of
gamma_tpu/index/flat.py).

Reference: index/impl/gamma_index_flat.{h,cc} — an OpenMP scan over the
MemoryRawVector.  Here: the model scans the raw store's device mirror
with one distance GEMM per chunk and a running top-k (ops/flat_scan.py);
there is nothing to train and `add` is a no-op because the store mirror
IS the index (the reference's FLAT also reads the raw store directly).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from gamma_tpu_torch.config import MetricType, SearchParams
from gamma_tpu_torch.index.model import RetrievalModel
from gamma_tpu_torch.index.registry import register_model
from gamma_tpu_torch.ops.flat_scan import flat_search
from gamma_tpu_torch.vector.raw_store import RawVectorStore


@register_model("FLAT")
class FlatIndex(RetrievalModel):
    penalty_space = "row"

    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(raw_store, params)
        mt = (params or {}).get("metric_type", "L2")
        self.default_metric = (MetricType.INNER_PRODUCT
                               if str(mt).upper() in ("IP", "INNERPRODUCT",
                                                      "INNER_PRODUCT")
                               else MetricType.L2)

    def trained(self) -> bool:
        return True

    def train(self, x: np.ndarray) -> None:
        pass

    def add(self, x, vids, docids) -> None:
        # the raw store device mirror is the index
        self.indexed_count = self.store.flushed

    def delete(self, vids) -> None:
        pass   # deletes arrive via the penalty array

    def search(self, queries, penalty_by_row, sp: SearchParams, k: int,
               dist_range=None, validity_n=None):
        metric = self.metric_name(sp, self.default_metric)
        dists, rows = flat_search(
            self.store.device, self.store.device_norms, queries,
            penalty_by_row, dist_range, k=k, metric=metric)
        return dists, rows, rows   # row index == vid for the raw store

    def dump(self, path: str) -> None:
        pass   # raw vectors are dumped by the store itself

    def load(self, path: str) -> int:
        self.indexed_count = self.store.flushed
        return self.indexed_count

    def mem_bytes(self) -> int:
        return 0   # shares the raw store's mirror
