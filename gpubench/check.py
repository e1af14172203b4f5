"""The comparison that decides `correct`.

Every answer the window received is held against the plain reference
(reference/exact.py), which works out exact float64 distances again from
the corpus and queries the harness made.  Three numbers:

  bad_answers  queries of the window whose answer is malformed: not
               `topn` hits, a key that names no doc, a doc twice, a score
               that is not finite or out of order, a hit whose gap below
               is not finite, or no answer at all (the engine's
               packing).  Exact: its limit is 0.
  score_gap    the widest gap between a hit's reported score and the
               reference's distance of that query to the doc the hit's
               key names, over the query's exact topn-th distance (the
               exact rerank: X1's rows and the float32 distance), over
               every hit of the answers that are not malformed.
  recall_gap   1 - recall@topn over all answers (the scan's candidates).

A cell's limits file names the numbers it compares and each limit; a
number without a limit there is reported and not compared.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from gpubench.corpus import KEY_BASE


def key_rows(keys: np.ndarray, n: int) -> np.ndarray:
    """Each key's slot, key - KEY_BASE (the doc keys are KEY_BASE plus a
    permutation of the n rows); -1 for a key that names no doc."""
    k = np.where(np.isfinite(keys), keys, -1.0)
    ok = (k >= KEY_BASE) & (k < KEY_BASE + n) & (k == np.floor(k))
    return np.where(ok, k - KEY_BASE, -1).astype(np.int64)


def compare(pool_rows: np.ndarray, keys: np.ndarray, scores: np.ndarray,
            row_of_key: np.ndarray, ref, topn: int,
            limits: Dict[str, Any]) -> Tuple[Dict[str, Dict], float]:
    """pool_rows [N]: the query of each answer; keys, scores [N, topn]
    (missing hits: key -1, score NaN).  Returns ({number: {"value",
    "limit"}}, recall over all answers)."""
    n = row_of_key.shape[0]
    slot = key_rows(keys, n)
    rows = np.where(slot >= 0, row_of_key[np.maximum(slot, 0)], -1)
    srt = np.sort(rows, axis=1)
    gt_d, gt_rows = ref.topk(topn)
    gt = gt_rows[pool_rows]
    hits = (rows[:, :, None] == gt[:, None, :]).any(2).sum(1)
    recall = float(hits.sum() / max(1, gt.size))
    q_rows = np.repeat(pool_rows, topn)
    exact = ref.pair_dist(q_rows, rows.reshape(-1)).reshape(rows.shape)
    scale = gt_d[pool_rows, topn - 1][:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(scores - exact) / scale
        bad = ((rows < 0).any(1)
               | (srt[:, 1:] == srt[:, :-1]).any(1)
               | ~np.isfinite(scores).all(1)
               | (np.diff(scores, axis=1) < 0).any(1)
               | ~np.isfinite(gap).all(1))
    gap = gap[~bad]
    numbers = {"bad_answers": float(bad.sum()),
               "score_gap": float(gap.max()) if gap.size else 0.0,
               "recall_gap": 1.0 - recall}
    out = {}
    for name, value in numbers.items():
        lim = limits.get(name, {}).get("limit")
        out[name] = {"value": value, "limit": lim}
    return out, recall


def passed(numbers: Dict[str, Dict]) -> bool:
    return all(v["limit"] is None or v["value"] <= v["limit"]
               for v in numbers.values())
