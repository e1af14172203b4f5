"""Wire format — the serialization boundary of the engine.

Reference: idl/fbs/*.fbs (flatbuffers schemas for Request / Response /
Doc / Table / Config / EngineStatus / BatchResult) consumed by the 24
extern-C entry points in c_api/gamma_api.{h,cc}.

TPU-native substitution (documented): flatbuffers' zero-copy accessors
earn their complexity when a C++ engine reads requests in-place.  Here
the engine's data plane is device arrays, so the wire format optimizes
for (a) zero-copy of the LARGE payloads — query/doc vectors travel as raw
little-endian buffers — and (b) schema evolution, via a JSON header.

Layout (little-endian):
    u32 magic 'GWIR' | u8 version | u8 msg_type | u16 reserved
    u32 header_len | header (UTF-8 JSON)
    u32 n_blobs | { u32 blob_len | blob bytes } * n_blobs

The JSON header references blobs by index: a tensor field is encoded as
{"$blob": i, "dtype": "...", "shape": [...]}.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Tuple

import numpy as np

from gamma_tpu_torch.api.doc import Doc
from gamma_tpu_torch.api.request import (Request, RangeFilter, TermFilter,
                                   VectorQuery)
from gamma_tpu_torch.api.response import (Response, ResultItem, SearchResult,
                                    SearchResultCode)
from gamma_tpu_torch.api.status import EngineStatus, IndexStatus
from gamma_tpu_torch.config import EngineConfig, TableInfo

MAGIC = 0x47574952
VERSION = 1

MSG_CONFIG = 1
MSG_TABLE = 2
MSG_DOC = 3
MSG_DOCS = 4
MSG_REQUEST = 5
MSG_RESPONSE = 6
MSG_STATUS = 7
MSG_BATCH_RESULT = 8

_INF = float("inf")


class _Blobs:
    def __init__(self):
        self.blobs: List[bytes] = []

    def tensor(self, arr: np.ndarray) -> Dict[str, Any]:
        arr = np.ascontiguousarray(arr)
        self.blobs.append(arr.tobytes())
        return {"$blob": len(self.blobs) - 1, "dtype": str(arr.dtype),
                "shape": list(arr.shape)}


def _untensor(obj: Any, blobs: List[bytes]) -> Any:
    if isinstance(obj, dict) and "$blob" in obj:
        return np.frombuffer(
            blobs[obj["$blob"]], dtype=np.dtype(obj["dtype"])
        ).reshape(obj["shape"]).copy()
    return obj


def _pack(msg_type: int, header: Dict[str, Any],
          blobs: List[bytes]) -> bytes:
    hj = json.dumps(header, separators=(",", ":")).encode()
    out = [struct.pack("<IBBHI", MAGIC, VERSION, msg_type, 0, len(hj)), hj,
           struct.pack("<I", len(blobs))]
    for b in blobs:
        out.append(struct.pack("<I", len(b)))
        out.append(b)
    return b"".join(out)


def _unpack(data: bytes, expect_type: int
            ) -> Tuple[Dict[str, Any], List[bytes]]:
    magic, ver, mt, _, hlen = struct.unpack_from("<IBBHI", data, 0)
    if magic != MAGIC:
        raise ValueError("bad magic")
    if ver != VERSION:
        raise ValueError(f"unsupported wire version {ver}")
    if mt != expect_type:
        raise ValueError(f"message type {mt}, expected {expect_type}")
    off = 12
    header = json.loads(data[off: off + hlen])
    off += hlen
    (nb,) = struct.unpack_from("<I", data, off)
    off += 4
    blobs = []
    for _ in range(nb):
        (bl,) = struct.unpack_from("<I", data, off)
        off += 4
        blobs.append(data[off: off + bl])
        off += bl
    return header, blobs


# ------------------------------ config ------------------------------

def pack_config(cfg: EngineConfig) -> bytes:
    return _pack(MSG_CONFIG, json.loads(cfg.to_json()), [])


def unpack_config(data: bytes) -> EngineConfig:
    h, _ = _unpack(data, MSG_CONFIG)
    return EngineConfig(**h)


# ------------------------------ table -------------------------------

def pack_table(info: TableInfo) -> bytes:
    return _pack(MSG_TABLE, json.loads(info.to_json()), [])


def unpack_table(data: bytes) -> TableInfo:
    h, _ = _unpack(data, MSG_TABLE)
    return TableInfo.from_json(json.dumps(h))


# ------------------------------ docs --------------------------------

def _doc_header(doc: Doc, blobs: _Blobs) -> Dict[str, Any]:
    return {
        "key": doc.key if isinstance(doc.key, (str, int)) else str(doc.key),
        "fields": doc.fields,
        "vectors": {k: blobs.tensor(np.asarray(v, np.float32))
                    for k, v in doc.vectors.items()},
    }


def _doc_from_header(h: Dict[str, Any], blobs: List[bytes]) -> Doc:
    return Doc(key=h["key"], fields=h.get("fields", {}),
               vectors={k: _untensor(v, blobs)
                        for k, v in h.get("vectors", {}).items()})


def pack_doc(doc: Doc) -> bytes:
    b = _Blobs()
    return _pack(MSG_DOC, _doc_header(doc, b), b.blobs)


def unpack_doc(data: bytes) -> Doc:
    h, blobs = _unpack(data, MSG_DOC)
    return _doc_from_header(h, blobs)


def pack_docs(docs: List[Doc]) -> bytes:
    b = _Blobs()
    return _pack(MSG_DOCS, {"docs": [_doc_header(d, b) for d in docs]},
                 b.blobs)


def unpack_docs(data: bytes) -> List[Doc]:
    h, blobs = _unpack(data, MSG_DOCS)
    return [_doc_from_header(d, blobs) for d in h["docs"]]


# ----------------------------- request ------------------------------

def pack_request(req: Request) -> bytes:
    b = _Blobs()
    h = {
        "topn": req.topn,
        "req_num": req.req_num,
        "brute_force_search": req.brute_force_search,
        "multi_vector_rank": req.multi_vector_rank,
        "l2_sqrt": req.l2_sqrt,
        "online_log_level": req.online_log_level,
        "fields": req.fields,
        "retrieval_params": req.retrieval_params,
        "vec_fields": [{
            "name": vq.name,
            "value": b.tensor(np.asarray(vq.value, np.float32)),
            "min_score": None if vq.min_score == -_INF else vq.min_score,
            "max_score": None if vq.max_score == _INF else vq.max_score,
            "boost": vq.boost, "has_boost": vq.has_boost,
        } for vq in req.vec_fields],
        "range_filters": [{
            "field": rf.field, "lower_value": rf.lower_value,
            "upper_value": rf.upper_value,
            "include_lower": rf.include_lower,
            "include_upper": rf.include_upper,
        } for rf in req.range_filters],
        "term_filters": [{
            "field": tf.field, "value": tf.terms(),
            "is_union": tf.is_union,
        } for tf in req.term_filters],
    }
    return _pack(MSG_REQUEST, h, b.blobs)


def unpack_request(data: bytes) -> Request:
    h, blobs = _unpack(data, MSG_REQUEST)
    return Request(
        topn=h.get("topn", 10),
        req_num=h.get("req_num", 1),
        brute_force_search=h.get("brute_force_search", False),
        multi_vector_rank=h.get("multi_vector_rank", 0),
        l2_sqrt=h.get("l2_sqrt", False),
        online_log_level=h.get("online_log_level", ""),
        fields=h.get("fields", []),
        retrieval_params=h.get("retrieval_params", {}),
        vec_fields=[VectorQuery(
            name=v["name"], value=_untensor(v["value"], blobs),
            min_score=(-_INF if v.get("min_score") is None
                       else v["min_score"]),
            max_score=(_INF if v.get("max_score") is None
                       else v["max_score"]),
            boost=v.get("boost", 1.0),
            has_boost=v.get("has_boost", False),
        ) for v in h.get("vec_fields", [])],
        range_filters=[RangeFilter(**rf)
                       for rf in h.get("range_filters", [])],
        term_filters=[TermFilter(**tf)
                      for tf in h.get("term_filters", [])],
    )


# ----------------------------- response -----------------------------

def pack_response(resp: Response) -> bytes:
    h = {
        "online_log_message": resp.online_log_message,
        "results": [{
            "total": sr.total,
            "result_code": int(sr.result_code),
            "msg": sr.msg,
            "items": [{
                "score": it.score, "docid": it.docid,
                "key": (it.key if isinstance(it.key, (str, int))
                        else None if it.key is None else str(it.key)),
                "attributes": _json_safe(it.attributes),
            } for it in sr.result_items],
        } for sr in resp.results],
    }
    return _pack(MSG_RESPONSE, h, [])


def _json_safe(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in (d or {}).items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, (np.integer, np.floating)):
            out[k] = v.item()
        else:
            out[k] = v
    return out


def unpack_response(data: bytes) -> Response:
    h, _ = _unpack(data, MSG_RESPONSE)
    return Response(
        online_log_message=h.get("online_log_message", ""),
        results=[SearchResult(
            total=sr["total"],
            result_code=SearchResultCode(sr["result_code"]),
            msg=sr.get("msg", ""),
            result_items=[ResultItem(
                score=it["score"], docid=it["docid"],
                key=it.get("key"), attributes=it.get("attributes", {}),
            ) for it in sr.get("items", [])],
        ) for sr in h.get("results", [])],
    )


# ------------------------------ status ------------------------------

def pack_status(st: EngineStatus) -> bytes:
    h = {k: (int(v) if isinstance(v, IndexStatus) else v)
         for k, v in st.__dict__.items()}
    return _pack(MSG_STATUS, h, [])


def unpack_status(data: bytes) -> EngineStatus:
    h, _ = _unpack(data, MSG_STATUS)
    h["index_status"] = IndexStatus(h["index_status"])
    return EngineStatus(**h)


# --------------------------- batch result ---------------------------

def pack_batch_result(codes: List[int]) -> bytes:
    return _pack(MSG_BATCH_RESULT, {"codes": codes}, [])


def unpack_batch_result(data: bytes) -> List[int]:
    h, _ = _unpack(data, MSG_BATCH_RESULT)
    return list(h["codes"])
