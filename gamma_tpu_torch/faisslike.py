"""faiss-like standalone facade (counterpart of gamma_tpu/faisslike.py).

Reference: index/gamma_index.{h,cc} (FAISSLIKE_INDEX build) — `Index` /
`IndexIVFPQ` / `IndexIVFFlat` classes with faiss-style train/add/search
that self-create their bitmap and raw-vector store (gamma_index.cc:56-119)
so the engine machinery can be used without tables or documents.

Usage (mirrors faiss):
    index = IndexIVFPQ(d=128, nlist=1024, m=32)
    index.train(xt)
    index.add(xb)
    D, I = index.search(xq, k=10)

Every index lives on the card unless it is created with `device="cpu"`.
Every model of the JAX package's facade is here, HNSW included.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from gamma_tpu_torch.config import SearchParams
from gamma_tpu_torch.index import create_model
from gamma_tpu_torch.ops.distances import BIG
from gamma_tpu_torch.utils.device import resolve_device
from gamma_tpu_torch.vector.raw_store import RawVectorStore


class Index:
    """Base: flat exact index (faiss IndexFlat analog)."""

    model_name = "FLAT"

    def __init__(self, d: int, metric: str = "l2", device=None, **params):
        self.d = d
        self.metric = metric
        self.device = resolve_device(device, type(self).__name__)
        self.store = RawVectorStore("x", d, device=self.device)
        params = dict(params)
        params.setdefault("metric_type",
                          "IP" if metric == "ip" else "L2")
        self.model = create_model(self.model_name, self.store, params)
        self.ntotal = 0
        self._removed: list[int] = []
        # device-resident penalty, maintained incrementally (rebuilding an
        # O(N) host array per search would put a host->device transfer on
        # the hot path)
        self._pen = torch.full((8192,), BIG, dtype=torch.float32,
                               device=self.device)

    @property
    def is_trained(self) -> bool:
        return self.model.trained()

    def train(self, x: np.ndarray) -> None:
        self.model.train(np.asarray(x, np.float32))

    def _grow_pen(self, need: int) -> None:
        cap = self._pen.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        self._pen = torch.nn.functional.pad(
            self._pen, (0, cap - self._pen.shape[0]), value=BIG)

    def _set_pen(self, ids: np.ndarray, value: float) -> None:
        """penalty[ids] = value; ids outside the array are dropped."""
        idx = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        idx = idx[(idx >= 0) & (idx < self._pen.shape[0])]
        self._pen = self._pen.clone()          # searches keep their copy
        self._pen[idx] = value

    def add(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32).reshape(-1, self.d)
        vids = self.store.add(x)
        self.store.flush_device()
        self.model.add(x, vids, vids)
        self._grow_pen(max(self.store.device.shape[0],
                           self.ntotal + x.shape[0]))
        self._set_pen(vids, 0.0)
        self.ntotal += x.shape[0]

    def remove_ids(self, ids: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        ids = ids[(ids >= 0) & (ids < self.ntotal)]   # faiss ignores OOR
        if ids.size == 0:
            return
        self.model.delete(ids)
        self._removed.extend(int(i) for i in ids)
        self._set_pen(ids, BIG)

    def _penalty(self) -> torch.Tensor:
        cap = self.store.device.shape[0]
        if self._pen.shape[0] >= cap:
            return self._pen[:cap]
        return torch.nn.functional.pad(
            self._pen, (0, cap - self._pen.shape[0]), value=BIG)

    def search(self, x: np.ndarray, k: int, **search_params):
        """→ (D [nq, k] f32, I [nq, k] i64); empty slots I = -1."""
        x = np.ascontiguousarray(x, np.float32).reshape(-1, self.d)
        sp = SearchParams.from_dict(search_params)
        if sp.metric_type is None:
            sp = SearchParams.from_dict(
                dict(search_params,
                     metric_type="IP" if self.metric == "ip" else "L2"))
        d, ids, _ = self.model.search(
            torch.from_numpy(x).to(self.device), self._penalty(), sp, k)
        d = d.cpu().numpy()
        ids = ids.cpu().numpy().astype(np.int64)
        ids = np.where(d >= BIG, -1, ids)
        if self.metric == "ip":
            d = -d
        return d, ids

    def reconstruct(self, vid: int) -> np.ndarray:
        return self.store.get(np.array([vid]))[0]

    def dump(self, path: str) -> None:
        self.store.dump(path)
        self.model.dump(path)
        # deletions live only in the facade for penalty-only models
        # (FLAT) — persist them
        with open(os.path.join(path, f"{self.store.name}.removed.json"),
                  "w") as f:
            json.dump(self._removed, f)

    def load(self, path: str) -> int:
        self.store.load(path)
        n = self.model.load(path)
        self.ntotal = self.store.n
        self._pen = torch.full((self.store.device.shape[0],), BIG,
                               dtype=torch.float32, device=self.device)
        self._pen[:self.ntotal] = 0.0
        rp = os.path.join(path, f"{self.store.name}.removed.json")
        if os.path.exists(rp):
            with open(rp) as f:
                self._removed = list(json.load(f))
            if self._removed:
                self._set_pen(np.asarray(self._removed), BIG)
        return n


class IndexFlat(Index):
    model_name = "FLAT"


class IndexIVFPQ(Index):
    model_name = "IVFPQ"

    def __init__(self, d: int, nlist: int = 2048, m: int = 64,
                 nbits: int = 8, metric: str = "l2", **params):
        super().__init__(d, metric, ncentroids=nlist, nsubvector=m,
                         nbits_per_idx=nbits, **params)


class IndexIVFPQFastScan(Index):
    """faiss IndexIVFPQFastScan analog: 4-bit packed codes, ksub=16 scan
    (gamma_tpu_torch/index/ivfpq_fastscan.py)."""

    model_name = "IVFPQ_FASTSCAN"

    def __init__(self, d: int, nlist: int = 2048, m: int = 64,
                 metric: str = "l2", **params):
        super().__init__(d, metric, ncentroids=nlist, nsubvector=m,
                         **params)


class IndexScaNN(Index):
    """ScaNN analog (the reference's VEARCH type): anisotropic vector
    quantization, inner product by default."""

    model_name = "SCANN"

    def __init__(self, d: int, nlist: int = 2048, m: int = 64,
                 metric: str = "ip", **params):
        super().__init__(d, metric, ncentroids=nlist, nsubvector=m,
                         **params)


class IndexIVFFlat(Index):
    model_name = "IVFFLAT"

    def __init__(self, d: int, nlist: int = 2048, metric: str = "l2",
                 **params):
        super().__init__(d, metric, ncentroids=nlist, **params)


class IndexHNSW(Index):
    model_name = "HNSW"

    def __init__(self, d: int, nlinks: int = 32, metric: str = "l2",
                 **params):
        super().__init__(d, metric, nlinks=nlinks, **params)


class IndexBinaryIVF(Index):
    """Hamming search over the sign bits of the rows (ncentroids,
    nprobe as model params; D holds Hamming distances)."""

    model_name = "BINARYIVF"
