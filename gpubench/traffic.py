"""The one traffic generator: what each request of a mix holds.

A mix is a data file (traffic/<name>.json):
  kind              "closed_loop": one caller sends the next request
                    when the last has been answered (the only kind yet)
  batch             query vectors per request
  topn              hits asked per query
  retrieval_params  merged over the configuration's `search_params`

Requests walk the configuration's query pool in order, `batch` rows at a
time, wrapping at its end, so every seed sends the same sizes and only
the vectors differ.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

KINDS = ("closed_loop",)


def check(traffic: Dict[str, Any]) -> None:
    if traffic.get("kind") not in KINDS:
        raise ValueError(f"traffic kind {traffic.get('kind')!r} is not "
                         f"one of {KINDS}")


def retrieval_params(cfg: Dict[str, Any],
                     traffic: Dict[str, Any]) -> Dict[str, Any]:
    return {**cfg.get("search_params", {}),
            **traffic.get("retrieval_params", {})}


def rows(i: int, batch: int, pool: int) -> np.ndarray:
    """Pool rows of request i."""
    return (i * batch + np.arange(batch)) % pool
