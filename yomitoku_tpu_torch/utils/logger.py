"""Logging (the port's copy of yomitoku_tpu/utils/logger.py:set_logger)."""

import logging
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s: %(message)s"


def set_logger(name: str, level: str = "INFO") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    return logger
