"""Engine logging.

Reference: util/log.h (easylogging++ macros) configured at Init with a
200 MB rollover (c_api/gamma_api.cc:56-90), plus the per-request online
logger surfaced in responses.

Here: standard-library logging with a rotating file handler when the
EngineConfig names a log_dir; the per-request trace stays in
Response.online_log_message (utils/perf.py PerfTool)."""

from __future__ import annotations

import logging
import logging.handlers
import os

LOGGER_NAME = "gamma_tpu"
MAX_BYTES = 200 * 1024 * 1024      # reference rollover size
BACKUPS = 3


def get_logger() -> logging.Logger:
    return logging.getLogger(LOGGER_NAME)


def configure(log_dir: str = "", level: int = logging.INFO
              ) -> logging.Logger:
    """Idempotent setup: console always, rotating file when log_dir set."""
    log = get_logger()
    log.setLevel(level)
    have_file = any(isinstance(h, logging.handlers.RotatingFileHandler)
                    for h in log.handlers)
    if log_dir and not have_file:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, "gamma.log"),
            maxBytes=MAX_BYTES, backupCount=BACKUPS)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s %(message)s"))
        log.addHandler(fh)
    if not log.handlers:
        log.addHandler(logging.NullHandler())
    return log
