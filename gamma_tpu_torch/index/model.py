"""RetrievalModel abstract interface (counterpart of
gamma_tpu/index/model.py).

Reference: index/retrieval_model.h:218-310 — Init/Parse/Indexing(train)/
Add/Update/Delete/Search/Dump/Load.  The RetrievalContext's IsValid /
IsSimilarScoreValid callbacks become the fused penalty array + score-range
post-filter, so Search takes a penalty instead of a context object.
"""

from __future__ import annotations

import abc
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from gamma_tpu_torch.config import MetricType, SearchParams
from gamma_tpu_torch.ops.distances import BIG
from gamma_tpu_torch.ops.flat_scan import flat_search, flat_search_streaming
from gamma_tpu_torch.vector.raw_store import RawVectorStore


class RetrievalModel(abc.ABC):
    model_name = "ABSTRACT"
    # which id space the search() penalty indexes: "doc" (docid-aligned)
    # or "row" (raw-store vid/row-aligned, for models that scan the
    # store mirror directly)
    penalty_space = "doc"

    def __init__(self, raw_store: RawVectorStore,
                 params: Optional[Dict[str, Any]] = None):
        self.store = raw_store
        self.params = params or {}
        # the vector field this model indexes (the store name by default;
        # VectorManager re-stamps it — never parse it out of a dict key,
        # model names may contain underscores)
        self.field = raw_store.name
        self.indexed_count = 0     # vids pumped into the index so far
        # serializes mutations (add/update/delete/compact): the indexer
        # pump runs off the engine's ingest lock, so a client delete and
        # a pump append must not interleave their state swaps (searches
        # stay lock-free on snapshots)
        self.mutate_lock = threading.Lock()
        # held only while the attributes a search reads are swapped or
        # read (_publish / _read), never across device work: a search
        # takes ONE consistent set of them, a mutation publishes the
        # tensors that belong together in one step
        self._pub_lock = threading.Lock()

    def _publish(self, **attrs: Any) -> None:
        """Swap several searched attributes as one step."""
        with self._pub_lock:
            for name, value in attrs.items():
                setattr(self, name, value)

    def _read(self, *names: str) -> Tuple[Any, ...]:
        """The named attributes as one snapshot (see _publish)."""
        with self._pub_lock:
            return tuple(getattr(self, name) for name in names)

    # ---- lifecycle ----

    @abc.abstractmethod
    def trained(self) -> bool: ...

    @abc.abstractmethod
    def train(self, x: np.ndarray) -> None:
        """Offline training (reference: RetrievalModel::Indexing)."""

    @abc.abstractmethod
    def add(self, x: np.ndarray, vids: np.ndarray,
            docids: np.ndarray) -> None: ...

    def update(self, vids: np.ndarray, x: np.ndarray,
               docids: np.ndarray) -> None:
        """Default: tombstone + re-add (reference: rt update semantics)."""
        self.delete(vids)
        self.add(x, vids, docids)

    @abc.abstractmethod
    def delete(self, vids: np.ndarray) -> None: ...

    # ---- search ----

    @abc.abstractmethod
    def search(self, queries: torch.Tensor, penalty: torch.Tensor,
               sp: SearchParams, k: int, dist_range=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """queries [B, d] (device), penalty [N_cap] (device) →
        (dists [B, k], docids [B, k], vids [B, k]) on device;
        smaller-is-better, masked slots = (>=BIG, -1, -1).

        dist_range: optional [2] f32 device array (lo, hi) — the fused
        score-range filter in DISTANCE space (reference:
        IsSimilarScoreValid inside the scanner).  Models that cannot
        fuse it may ignore it; the engine's post-filter stays
        authoritative on the reported score."""

    def _brute_fallback(self, queries, penalty, k, metric, dist_range):
        """Brute-force search of an IVF model that is not trained yet
        (reference: ivfpq.cc:529-537), over the store mirror with the
        doc-space penalty aligned to its rows; the disk tier, which holds
        no mirror, streams the host corpus through the card instead."""
        if self.store.tier == "disk":
            d, rows = flat_search_streaming(
                self.store.header(0, self.store.n), self.store.n, queries,
                penalty, dist_range, k=k, metric=metric)
            return d, rows, rows
        cap = self.store.device.shape[0]
        if penalty.shape[0] < cap:
            penalty = torch.nn.functional.pad(
                penalty, (0, cap - penalty.shape[0]), value=BIG)
        d, rows = flat_search(self.store.device, self.store.device_norms,
                              queries, penalty[:cap], dist_range, k=k,
                              metric=metric)
        return d, rows, rows

    # ---- maintenance / persistence ----

    def compact(self) -> None:
        pass

    @abc.abstractmethod
    def dump(self, path: str) -> None: ...

    @abc.abstractmethod
    def load(self, path: str) -> int:
        """Returns number of indexed vids restored."""

    def mem_bytes(self) -> int:
        return 0

    def metric_name(self, sp: SearchParams, default: MetricType) -> str:
        mt = sp.metric_type if sp.metric_type is not None else default
        return "ip" if mt == MetricType.INNER_PRODUCT else "l2"
