"""Document model (reference: idl/fbs/doc.fbs, c_api/api_data/gamma_doc.{h,cc}).

A Doc is a bag of scalar fields plus one or more named vectors.  The `_id`
field is the user key (string or int); it maps to an internal docid.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np

Key = Union[str, int, bytes]


@dataclasses.dataclass
class Doc:
    key: Key
    fields: Dict[str, Any] = dataclasses.field(default_factory=dict)
    vectors: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def vector_list(self, name: str) -> List[np.ndarray]:
        """A doc may carry multiple vectors per field (reference:
        vector/raw_vector_common.h:17 caps it at 10)."""
        v = self.vectors[name]
        arr = np.asarray(v, dtype=np.float32)
        if arr.ndim == 1:
            return [arr]
        return [arr[i] for i in range(arr.shape[0])]
