"""Docs ingested after training over the wall of their
add_or_update_docs calls and the one flush that follows (set-up, host
clock)."""


def read(rec):
    if rec.ingest_docs <= 0 or rec.ingest_s <= 0:
        return None
    return rec.ingest_docs / rec.ingest_s
