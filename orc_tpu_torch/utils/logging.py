"""Logging (port of orc_tpu/utils/logging.py).

- `get_logger()`: a standard Python logger, level from ORC_TPU_LOG
  (debug / info / warning), optionally mirrored to a rotating file
  named by ORC_TPU_LOG_FILE, the environment variables orc_tpu reads.
"""

from __future__ import annotations

import logging
import logging.handlers
import os

_LOGGER = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is not None:
        return _LOGGER
    logger = logging.getLogger("orc_tpu_torch")
    level = os.environ.get("ORC_TPU_LOG", "info").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(h)
        log_file = os.environ.get("ORC_TPU_LOG_FILE")
        if log_file:
            fh = logging.handlers.RotatingFileHandler(
                log_file, maxBytes=64 * 2**20, backupCount=10
            )
            fh.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(message)s")
            )
            logger.addHandler(fh)
    _LOGGER = logger
    return logger
