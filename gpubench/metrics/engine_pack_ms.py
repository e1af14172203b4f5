"""Median over the window's requests of the engine's PerfTool `merge` and
`pack` checkpoints: result merge and host packing, in ms."""

import numpy as np


def read(rec):
    ms = [sum(v for t, v in p if t in ("merge", "pack"))
          for p in rec.perf if any(t == "pack" for t, _ in p)]
    return float(np.median(ms)) if ms else None
