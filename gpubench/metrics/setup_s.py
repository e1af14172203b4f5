"""Process start to the first timed request: the corpus, the engine,
ingest and training, the warm-up (and, in a new checkout, the build)."""


def read(rec):
    return rec.setup_s
