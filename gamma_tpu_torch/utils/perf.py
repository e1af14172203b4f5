"""Per-request performance tracing.

Reference: index/retrieval_model.h:23-50 `PerfTool` — millisecond
checkpoints accumulated into a string, surfaced in the Response when
online_log_level=debug (gamma_engine.cc:459-465).
"""

from __future__ import annotations

import time
from typing import List, Tuple


class PerfTool:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.points: List[Tuple[str, float]] = []

    def perf(self, tag: str) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        self.points.append((tag, (now - self.last) * 1e3))
        self.last = now

    def output(self) -> str:
        if not self.enabled:
            return ""
        total = (self.last - self.t0) * 1e3
        parts = [f"{tag}:{ms:.3f}ms" for tag, ms in self.points]
        return " ".join(parts) + f" total:{total:.3f}ms"
