"""Reduce a torch.profiler trace of the window to the device's busy
time, its heaviest operations and its idle gaps by what the host did.

The harness times each request's GammaEngine.search (ENGINE_SPAN, also a
`record_function` span, which ties the profiler's clock to the host's)
and the model's search inside it (MODEL_SPAN).  The program's own
checkpoints (PerfTool: filter,
scan:<field>, merge, pack, in milliseconds) split an engine span into
its phases, laid from the span's start.  An idle gap is named after the
innermost of these that holds it: a collection of the interpreter's
garbage collector (`gc.gen<n>`, generations 1 and 2), `model.search`,
`engine.<phase>`, `engine.search` (outside every checkpoint) or
`between_requests` (the harness's own work between two requests).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ENGINE_SPAN = "engine.search"
MODEL_SPAN = "model.search"
TOP = 10

Interval = Tuple[float, float]


def parse_perf(message: str) -> List[Tuple[str, float]]:
    """PerfTool's `tag:1.234ms ...` line (Response.online_log_message)
    → [(tag, ms)], without its `total`."""
    out = []
    for part in message.split():
        tag, _, ms = part.rpartition(":")
        if tag and tag != "total" and ms.endswith("ms"):
            out.append((tag, float(ms[:-2])))
    return out


def _union(iv: Sequence[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlay(segs, spans, label):
    """Relabel the parts of `segs` (ordered, non-overlapping) that lie in
    `spans` (ordered, non-overlapping (start, end, ...)) as label(span)."""
    out, j = [], 0
    for a, b, lab in segs:
        cur = a
        while j < len(spans) and spans[j][1] <= cur:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            x, y = max(spans[k][0], cur), min(spans[k][1], b)
            if x > cur:
                out.append((cur, x, lab))
            if y > x:
                out.append((x, y, label(spans[k])))
            cur = max(cur, y)
            k += 1
        if b > cur:
            out.append((cur, b, lab))
    return out


def _timeline(engine: List[Interval], model: List[Interval], gc_spans,
              perf: Sequence[Sequence[Tuple[str, float]]]):
    """Labelled, ordered, non-overlapping segments covering the window."""
    segs = []
    for j, (s, e) in enumerate(engine):
        if j:
            segs.append((engine[j - 1][1], s, "between_requests"))
        cur = s
        for tag, ms in (perf[j] if j < len(perf) else ()):
            end = min(e, cur + ms / 1e3)
            if end > cur:
                segs.append((cur, end, "engine." + tag.split(":")[0]))
            cur = end
        if e > cur:
            segs.append((cur, e, ENGINE_SPAN))
    segs = _overlay(segs, sorted(model), lambda _: MODEL_SPAN)
    return _overlay(segs, sorted(gc_spans), lambda g: f"gc.gen{g[2]}")


def _idle_by_label(busy: List[Interval], w0: float, w1: float, segs):
    idle, cur = [], w0
    for a, b in busy:
        if a > cur:
            idle.append((cur, min(a, w1)))
        cur = max(cur, b)
    if cur < w1:
        idle.append((cur, w1))
    out: Dict[str, float] = {}
    k = 0
    for a, b in idle:
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < b:
            x, y, lab = segs[j]
            ov = min(b, y) - max(a, x)
            if ov > 0:
                out[lab] = out.get(lab, 0.0) + ov
            j += 1
    return out


def reduce(events, engine: List[Interval], model: List[Interval],
           gc_spans, perf: Sequence[Sequence[Tuple[str, float]]]
           ) -> Optional[Dict]:
    """`events`: the profiler's FunctionEvents; `engine`, `model`: the
    harness's spans, (start, end) by time.perf_counter, in order;
    `gc_spans`: the interpreter's collections (start, end, generation);
    `perf`: each request's PerfTool checkpoints.  The profiler's clock is
    put on perf_counter's by the engine spans, which both record (the
    model's search runs in the engine's batcher thread, whose host events
    the profiler does not keep).  None without an engine span."""
    from torch.autograd import DeviceType
    anchors, dev = [], []
    for e in events:
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name == ENGINE_SPAN:
            # the host span; its twin on the device timeline is no work
            if e.device_type == DeviceType.CPU:
                anchors.append(a)
        elif e.device_type == DeviceType.CUDA:
            dev.append((a, b, e.name))
    if not anchors or not engine:
        return None
    anchors.sort()
    off = float(np.median([a - s for a, (s, _) in zip(anchors, engine)]))
    w0, w1 = engine[0][0], engine[-1][1]
    inside = [(max(a - off, w0), min(b - off, w1), n) for a, b, n in dev
              if b - off > w0 and a - off < w1]
    busy = _union([(a, b) for a, b, _ in inside])
    by_op: Dict[str, float] = {}
    for a, b, n in inside:
        by_op[n] = by_op.get(n, 0.0) + (b - a)
    idle = _idle_by_label(busy, w0, w1,
                          _timeline(engine, model, gc_spans, perf))
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(b - a for a, b in busy), "window_s": w1 - w0,
            "requests": len(engine),
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
