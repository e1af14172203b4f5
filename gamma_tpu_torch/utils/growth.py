"""Buffer growth policy.

Pow2 doubling wastes up to 2x HBM on the largest arrays (a 10M-row corpus
would allocate 16.7M rows), and with copy-on-write updates the transient
peak doubles again.  Geometric growth with a 25% overshoot in fixed
quanta keeps the waste bounded while the persistent XLA compilation cache
absorbs the extra shape count.
"""


def grow_rows(cur: int, need: int, quantum: int = 8192) -> int:
    """Next capacity >= need: ceil to a quantum that is at least 1/4 of
    the current capacity (geometric-ish growth, ~25% headroom)."""
    if need <= cur:
        return cur
    step = max(quantum, cur // 4)
    return -(-need // step) * step


def ladder_256(need: int, cap: int) -> int:
    """Geometric (~25%) ladder step covering `need` slots, quantized to
    256 and clipped to `cap` — the static scan-width watermark used by
    the posting-scan kernels (each distinct step = one compile; 25%
    steps bound both the dead-slot overshoot and the shape count,
    ~18 steps to 16k).  Mirrors IVFPQIndex._sq_ladder."""
    ce = 256
    while ce < need:
        ce = max(ce + 256, -(-int(ce * 1.25) // 256) * 256)
    return min(ce, cap)
