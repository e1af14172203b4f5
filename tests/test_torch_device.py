"""Where the port's components keep their device state when they are
built directly (not through GammaEngine): on the card unless the caller
asks for the CPU.  Without a card a missing `device` raises with the
engine's message; nothing moves to the CPU on its own."""

import numpy as np
import pytest
import torch

from gamma_tpu_torch.api.request import RangeFilter, TermFilter
from gamma_tpu_torch.config import (DataType, FieldInfo, TableInfo,
                                    VectorInfo)
from gamma_tpu_torch.index.ivfpq import IVFPQIndex
from gamma_tpu_torch.table.range_index import MultiFieldsRangeIndex
from gamma_tpu_torch.table.table import Table
from gamma_tpu_torch.utils.device import resolve_device
from gamma_tpu_torch.vector.raw_store import RawVectorStore
from gamma_tpu_torch.vector.vector_manager import VectorManager

D = 16
FIELDS = [FieldInfo("price", DataType.FLOAT, is_index=True),
          FieldInfo("tag", DataType.STRING, is_index=True)]
PARAMS = {"ncentroids": 8, "nsubvector": 4}


def _store(**kw):
    return RawVectorStore("vec", D, **kw)


def _manager(**kw):
    return VectorManager("", **kw)


def _range_index(**kw):
    return MultiFieldsRangeIndex(Table(FIELDS), **kw)


def _index(**kw):
    return IVFPQIndex(_store(**kw), PARAMS)


MAKERS = {"store": _store, "manager": _manager,
            "range_index": _range_index, "index": _index}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("what", sorted(MAKERS))
def test_no_device_needs_a_card(what, no_card):
    """Built without `device` and without a card, each raises and names
    the way out; asking for the card by name raises alike."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MAKERS[what]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MAKERS[what](device="cuda")


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_resolve_device(device, no_card):
    assert resolve_device(device, "x") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="^x: no CUDA device"):
        resolve_device(None, "x")


def test_store_on_cpu_by_request(no_card):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(100, D)).astype(np.float32)
    store = _store(device="cpu")
    store.add(x)
    store.flush_device()
    assert store.dev.type == "cpu" and store.device.device.type == "cpu"
    np.testing.assert_allclose(store.device[:100].float().numpy(), x,
                               rtol=1e-2, atol=1e-2)     # bf16 mirror


def test_manager_on_cpu_by_request(no_card):
    vm = _manager(device="cpu")
    vm.create_vector_table(TableInfo(
        name="t", fields=FIELDS, vectors=[VectorInfo("emb", D)],
        retrieval_types=["IVFPQ"], retrieval_params=[PARAMS]))
    assert vm.stores["emb"].dev.type == "cpu"
    assert vm.index_for("emb").device.type == "cpu"


def test_range_index_on_cpu_by_request(no_card):
    table = Table(FIELDS)
    ri = MultiFieldsRangeIndex(table, device="cpu")
    for f in FIELDS:
        ri.add_field(f.name, f.data_type)
    for i in range(10):
        fields = {"price": float(i), "tag": f"t{i % 2}"}
        ri.add_doc(table.add(f"k{i}", fields), fields)
    ri.flush_device(pad_chunk=16)
    (pen,) = ri.range_penalties([RangeFilter("price", 2.0, 5.0)])
    assert pen.device.type == "cpu"
    np.testing.assert_array_equal((pen[:10] == 0).numpy(),
                                  (np.arange(10) >= 2) & (np.arange(10) <= 5))
    (pen,) = ri.term_penalties([TermFilter("tag", "t1")])
    assert pen.device.type == "cpu"
    np.testing.assert_array_equal((pen[:10] == 0).numpy(),
                                  np.arange(10) % 2 == 1)


def test_index_follows_its_store(no_card):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(400, D)).astype(np.float32)
    index = _index(device="cpu")
    assert index.device.type == "cpu"
    index.store.add(x)
    index.store.flush_device()
    index.train(x)
    assert index.centroids.device.type == "cpu"
