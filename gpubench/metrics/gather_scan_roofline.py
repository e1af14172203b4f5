"""The gather search's share of its roofline, in %: the least time of the
window's requests (roofline.py, gather) over the device's busy time in
the traced window.  Only where the model resolved the gather scan over
the PQ payload (the formula counts PQ codes)."""

from gpubench import roofline


def read(rec):
    t = rec.trace
    if (rec.scan_mode != "gather" or not t or t["busy_s"] <= 0
            or rec.config["retrieval_params"].get("gather_payload") != "pq"):
        return None
    bound = roofline.bound_s(*roofline.ivfpq_work(
        "gather", rec.config, rec.traffic, rec.params), rec.kind)
    if bound is None:
        return None
    return 100.0 * t["requests"] * bound / t["busy_s"]
