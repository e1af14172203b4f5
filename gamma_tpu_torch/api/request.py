"""Search request model (reference: idl/fbs/request.fbs:27-41,
c_api/api_data/gamma_request.{h,cc}).

Field-for-field parity with the reference's Request table:
req_num, topn, brute_force_search, vec_fields[], fields[], range_filters[],
term_filters[], retrieval_params (JSON), online_log_level,
multi_vector_rank, l2_sqrt.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class VectorQuery:
    """One vector query clause (request.fbs VectorQuery):
    field name, query vector(s), optional score bounds and boost."""

    name: str
    value: np.ndarray                      # [d] or [req_num, d]
    min_score: float = -float("inf")
    max_score: float = float("inf")
    boost: float = 1.0
    has_boost: bool = False


@dataclasses.dataclass
class RangeFilter:
    """Numeric range filter on an indexed scalar field
    (request.fbs RangeFilter: field, lower/upper value, include flags)."""

    field: str
    lower_value: float
    upper_value: float
    include_lower: bool = True
    include_upper: bool = True


@dataclasses.dataclass
class TermFilter:
    """String term filter (request.fbs TermFilter).  `value` holds one or
    more terms separated by the reference's \\001 delimiter or given as a
    list; `is_union` selects OR (1) vs AND (0) across terms."""

    field: str
    value: Any                              # str | list[str]
    is_union: int = 1

    def terms(self) -> List[str]:
        if isinstance(self.value, (list, tuple)):
            return [str(t) for t in self.value]
        return [t for t in str(self.value).split("\x01") if t]


@dataclasses.dataclass
class Request:
    topn: int = 10
    req_num: int = 1                        # number of queries in the batch
    vec_fields: List[VectorQuery] = dataclasses.field(default_factory=list)
    fields: List[str] = dataclasses.field(default_factory=list)   # fields to return
    range_filters: List[RangeFilter] = dataclasses.field(default_factory=list)
    term_filters: List[TermFilter] = dataclasses.field(default_factory=list)
    retrieval_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    brute_force_search: bool = False
    multi_vector_rank: int = 0
    l2_sqrt: bool = False
    online_log_level: str = ""
