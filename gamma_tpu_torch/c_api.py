"""C-API-shaped surface: the reference's 24 extern-C entry points
(c_api/gamma_api.h:20-206), operating on wire-format bytes
(counterpart of gamma_tpu/c_api.py, over the port's GammaEngine).

Every function takes/returns serialized messages
(gamma_tpu_torch/idl/wire.py) plus an opaque engine handle, mirroring
the reference's contract where every call crosses a serialization
boundary (flatbuffers there).  A non-Python client (or the socket
server, gamma_tpu_torch/server.py) can speak this surface without
touching the object model.

The one difference from the JAX package's module is where an engine
lives: `Init(config_bytes, device=None)` hands `device` to
`GammaEngine`, and without one takes the module default that
`set_default_device` sets.  That default is None, which means the CUDA
card: without a card `Init` raises, as `GammaEngine` does.  CPU callers
(the tests) set "cpu" and put the old default back afterwards.

The no-serialization variant (reference: gamma_cpp_api.cc) is simply the
GammaEngine object API itself.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from gamma_tpu_torch.api.request import Request
from gamma_tpu_torch.engine import GammaEngine
from gamma_tpu_torch.idl import wire

_engines: Dict[int, GammaEngine] = {}
# where Init puts an engine when its caller names no device (None: the
# CUDA card); set_default_device changes it
_default_device: List[Optional[str]] = [None]
_pending_docs: Dict[int, List] = {}     # PrepareDocs staging per handle
_next_handle = [1]
_lock = threading.Lock()


def _get(handle: int) -> GammaEngine:
    eng = _engines.get(handle)
    if eng is None:
        raise KeyError(f"invalid engine handle {handle}")
    return eng


def set_default_device(device) -> Optional[str]:
    """Set the device of engines that Init creates without one (None:
    the CUDA card; "cpu" for CPU-only callers); returns the old one."""
    with _lock:
        old, _default_device[0] = _default_device[0], device
    return old


# ---- lifecycle (reference: Init :33, Close :56) ----

def Init(config_bytes: bytes, device=None) -> int:
    cfg = wire.unpack_config(config_bytes)
    eng = GammaEngine(cfg, device=(_default_device[0] if device is None
                                   else device))
    with _lock:
        h = _next_handle[0]
        _next_handle[0] += 1
        _engines[h] = eng
    return h


def Close(handle: int) -> int:
    with _lock:
        eng = _engines.pop(handle, None)
        _pending_docs.pop(handle, None)
    if eng is None:
        return -1
    eng.close()
    return 0


# ---- table (reference: CreateTable :98, Load :?) ----

def CreateTable(handle: int, table_bytes: bytes) -> int:
    return _get(handle).create_table(wire.unpack_table(table_bytes))


# ---- ingest (reference: AddOrUpdateDocs :129, UpdateDoc, DeleteDoc) ----

def AddOrUpdateDoc(handle: int, doc_bytes: bytes) -> int:
    return _get(handle).add_or_update_doc(wire.unpack_doc(doc_bytes))


def AddOrUpdateDocs(handle: int, docs_bytes: bytes) -> bytes:
    codes = _get(handle).add_or_update_docs(wire.unpack_docs(docs_bytes))
    return wire.pack_batch_result(codes)


def PrepareDocs(handle: int, docs_bytes: bytes) -> int:
    """Stage a parsed batch without ingesting (reference:
    gamma_api.h PrepareDocs — the Go layer splits parse from commit)."""
    _get(handle)
    docs = wire.unpack_docs(docs_bytes)
    with _lock:           # staged-ingest calls may race on one handle
        _pending_docs[handle] = docs
    return 0


def AddOrUpdateDocsNum(handle: int, num: int) -> int:
    """Ingest the first `num` staged docs (reference:
    gamma_api.h AddOrUpdateDocsNum)."""
    with _lock:
        staged = _pending_docs.get(handle)
        if staged is None:
            return -1
        take, _pending_docs[handle] = staged[:num], staged[num:]
    codes = _get(handle).add_or_update_docs(take)
    return 0 if all(c == 0 for c in codes) else -1


def AddOrUpdateDocsFinish(handle: int) -> int:
    """Ingest any remaining staged docs and clear the staging buffer
    (reference: gamma_api.h AddOrUpdateDocsFinish)."""
    with _lock:
        staged = _pending_docs.pop(handle, None)
    if staged is None:
        return -1
    if staged:
        codes = _get(handle).add_or_update_docs(staged)
        return 0 if all(c == 0 for c in codes) else -1
    return 0


def UpdateDoc(handle: int, doc_bytes: bytes) -> int:
    return AddOrUpdateDoc(handle, doc_bytes)


def DeleteDoc(handle: int, key: bytes) -> int:
    return _get(handle).delete(key.decode() if isinstance(key, bytes)
                               else key)


def DelDocByFilter(handle: int, request_bytes: bytes) -> int:
    """Reference: gamma_api.h DelDocByFilter — the filter-only form of
    DelDocByQuery (same request payload, range/term filters honored)."""
    return DelDocByQuery(handle, request_bytes)


def DelDocByQuery(handle: int, request_bytes: bytes) -> int:
    return _get(handle).del_doc_by_query(
        wire.unpack_request(request_bytes))


# ---- reads (reference: GetDocByID :?, Search :147) ----

def _pack_doc_dict(doc) -> bytes:
    from gamma_tpu_torch.api.doc import Doc
    key_v = doc.pop("_id", None)
    vectors = {k: v for k, v in doc.items()
               if hasattr(v, "shape")}
    fields = {k: v for k, v in doc.items() if k not in vectors}
    return wire.pack_doc(Doc(key=key_v, fields=fields, vectors=vectors))


def GetDocByID(handle: int, key: bytes) -> Optional[bytes]:
    doc = _get(handle).get_doc_by_key(
        key.decode() if isinstance(key, bytes) else key)
    if doc is None:
        return None
    return _pack_doc_dict(doc)


def GetDocByDocID(handle: int, docid: int) -> Optional[bytes]:
    """Reference: gamma_api.h GetDocByDocID — fetch by internal docid."""
    doc = _get(handle).get_doc(int(docid))
    if doc is None:
        return None
    return _pack_doc_dict(doc)


def Search(handle: int, request_bytes: bytes) -> bytes:
    resp = _get(handle).search(wire.unpack_request(request_bytes))
    return wire.pack_response(resp)


# ---- index lifecycle (reference: BuildIndex, GetEngineStatus) ----

def BuildIndex(handle: int) -> int:
    return _get(handle).build_index()


def GetEngineStatus(handle: int) -> bytes:
    return wire.pack_status(_get(handle).engine_status())


# ---- maintenance (reference: Dump :?, Load :?) ----

def Dump(handle: int) -> int:
    return _get(handle).dump()


def Load(handle: int) -> int:
    return _get(handle).load()


def Flush(handle: int) -> int:
    _get(handle).flush()
    return 0


# ---- config introspection (reference: GetConfig/SetConfig) ----

def GetConfig(handle: int) -> bytes:
    return wire.pack_config(_get(handle).config)


def SetConfig(handle: int, config_bytes: bytes) -> int:
    """Runtime tuning (reference: GetConfig/SetConfig alter cache sizes,
    gamma_engine.cc:1356-1382); here the live knob is the admission-
    control width."""
    cfg = wire.unpack_config(config_bytes)
    eng = _get(handle)
    if cfg.max_concurrent != eng.config.max_concurrent:
        eng.config.max_concurrent = cfg.max_concurrent
        eng.set_max_concurrent(cfg.max_concurrent)
    if cfg.vector_cache_mb != eng.config.vector_cache_mb:
        eng.set_vector_cache_mb(cfg.vector_cache_mb)
    return 0


# ---- migration (reference: gamma_api.h:194-206) ----

def BeginMigrate(handle: int) -> int:
    return _get(handle).begin_migrate()


def GetMigrateDoc(handle: int, batch: int = 1
                  ) -> List[Tuple[dict, bool]]:
    return _get(handle).get_migrate_doc(batch)


def TerminateMigrate(handle: int) -> int:
    return _get(handle).terminate_migrate()
