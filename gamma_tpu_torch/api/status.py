"""Engine status (reference: idl/fbs/engine_status.fbs,
gamma_engine.cc:1071-1099 GetEngineStatus): index status + per-subsystem
memory + doc counts.
"""

from __future__ import annotations

import dataclasses
import enum


class IndexStatus(enum.IntEnum):
    UNINDEXED = 0
    INDEXING = 1
    INDEXED = 2


@dataclasses.dataclass
class EngineStatus:
    index_status: IndexStatus = IndexStatus.UNINDEXED
    table_mem_bytes: int = 0
    index_mem_bytes: int = 0
    vector_mem_bytes: int = 0
    field_range_mem_bytes: int = 0
    bitmap_mem_bytes: int = 0
    doc_count: int = 0
    max_docid: int = 0
    min_indexed_num: int = 0
    delete_num: int = 0
