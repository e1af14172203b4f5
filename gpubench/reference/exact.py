"""Exact squared-L2 neighbours and pair distances in float64.

`Exact` holds the corpus and queries the harness made, uploaded once as
float32, and works in float64 blocks on `device` (ROW_BLOCK corpus rows
by Q_BLOCK queries, PAIR_BLOCK pairs), so a 1M x 512 corpus fits beside
what is left on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

ROW_BLOCK = 131_072
Q_BLOCK = 2048
PAIR_BLOCK = 1 << 20


class Exact:
    def __init__(self, corpus: np.ndarray, queries: np.ndarray, device):
        self.device = torch.device(device)
        self.x = torch.from_numpy(np.ascontiguousarray(corpus)).to(
            self.device)
        self.q = torch.from_numpy(np.ascontiguousarray(queries)).to(
            self.device).double()

    def topk(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """The k nearest corpus rows of every query, nearest first:
        (distances [nq, k] float64, rows [nq, k] int64)."""
        q, dev = self.q, self.device
        nq = q.shape[0]
        best_d = torch.full((nq, k), float("inf"), dtype=torch.float64,
                            device=dev)
        best_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
        qn = (q * q).sum(1, keepdim=True)
        for s in range(0, self.x.shape[0], ROW_BLOCK):
            x = self.x[s:s + ROW_BLOCK].double()
            xn = (x * x).sum(1)
            ids = torch.arange(s, s + x.shape[0], device=dev)
            for a in range(0, nq, Q_BLOCK):
                b = min(nq, a + Q_BLOCK)
                dist = qn[a:b] - 2.0 * (q[a:b] @ x.T) + xn[None, :]
                dist = torch.cat([best_d[a:b], dist], 1)
                cand = torch.cat([best_i[a:b], ids.expand(b - a, -1)], 1)
                best_d[a:b], sel = torch.topk(dist, k, dim=1, largest=False)
                best_i[a:b] = torch.gather(cand, 1, sel)
        return best_d.cpu().numpy(), best_i.cpu().numpy()

    def pair_dist(self, q_rows: np.ndarray, c_rows: np.ndarray
                  ) -> np.ndarray:
        """||queries[q_rows[j]] - corpus[c_rows[j]]||^2 for every pair j,
        (q - x) squared and summed in float64; NaN where c_rows[j] < 0."""
        out = np.full(q_rows.shape[0], np.nan)
        ok = np.flatnonzero(c_rows >= 0)
        for s in range(0, ok.size, PAIR_BLOCK):
            j = ok[s:s + PAIR_BLOCK]
            qi = torch.from_numpy(q_rows[j]).to(self.device)
            ci = torch.from_numpy(c_rows[j]).to(self.device)
            diff = self.q[qi] - self.x[ci].double()
            out[j] = (diff * diff).sum(1).cpu().numpy()
        return out
