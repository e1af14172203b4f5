"""Median over the window's requests of the engine's PerfTool
`scan:<field>` checkpoint: the model's search with its device wait, the
batcher's hand-off and the copy of the results to the host, in ms."""

import numpy as np


def read(rec):
    ms = [sum(v for t, v in p if t.startswith("scan:")) for p in rec.perf
          if any(t.startswith("scan:") for t, _ in p)]
    return float(np.median(ms)) if ms else None
