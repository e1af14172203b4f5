"""Search response model (reference: idl/fbs/response.fbs,
c_api/api_data/gamma_response.{h,cc}: SearchResult{total, result_code,
msg, result_items[]}, ResultItem{score, attributes}).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List

import numpy as np


class SearchResultCode(enum.IntEnum):
    SUCCESS = 0
    INDEX_NOT_TRAINED = 1
    SEARCH_ERROR = 2


@dataclasses.dataclass
class ResultItem:
    score: float
    docid: int
    key: Any = None
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SearchResult:
    total: int = 0
    result_code: SearchResultCode = SearchResultCode.SUCCESS
    msg: str = ""
    result_items: List[ResultItem] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Response:
    results: List[SearchResult] = dataclasses.field(default_factory=list)
    online_log_message: str = ""     # per-request perf trace (PerfTool analog)
