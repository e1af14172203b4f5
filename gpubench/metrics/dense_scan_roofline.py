"""The dense search's share of its roofline, in %: the least time of the
window's requests (roofline.py, dense) over the device's busy time in
the traced window.  Only where the model resolved the dense scan."""

from gpubench import roofline


def read(rec):
    t = rec.trace
    if rec.scan_mode != "dense" or not t or t["busy_s"] <= 0:
        return None
    bound = roofline.bound_s(*roofline.ivfpq_work(
        "dense", rec.config, rec.traffic, rec.params), rec.kind)
    if bound is None:
        return None
    return 100.0 * t["requests"] * bound / t["busy_s"]
