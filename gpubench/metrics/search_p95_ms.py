"""95th percentile of every request's time, from send to response, in
ms (host clock; numpy's linear interpolation), in the untraced window of
a `--trace 1` run.  One reader for every cell's `search_p95_ms.<cell>`:
per-layer, since in a one-caller closed loop the tail is set by the
interpreter's pauses and its spread between sets swung too far for a
bound (PERF.md §2)."""

import numpy as np


def read(rec):
    if not rec.latencies_s:
        return None
    return 1e3 * float(np.percentile(rec.latencies_s, 95))
