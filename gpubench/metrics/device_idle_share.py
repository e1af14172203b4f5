"""1 - the union of device operations' time over the traced window."""


def read(rec):
    t = rec.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
