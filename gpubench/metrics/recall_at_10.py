"""Recall@10 over every answer of the window against the reference's
exact top-10 (check.py works it out once the window has closed)."""


def read(rec):
    if rec.recall is None or int(rec.traffic["topn"]) != 10:
        return None
    return rec.recall
