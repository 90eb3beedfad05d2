"""Logging setup honoring ``REPRO_LOG_LEVEL`` (twin of
``repro/obs/log.py``).

``get_logger("train")`` returns a ``repro_torch.train`` logger writing bare
messages to stdout (no timestamp or level prefix).  Set
``REPRO_LOG_LEVEL=DEBUG`` or ``WARNING`` to widen or silence it.

The reference configures its package's root logger once; here each logger
``get_logger`` hands out gets its own handler, so the port's other loggers
(``logging.getLogger("repro_torch.launch.serve")`` and the like) keep
propagating to whatever handlers the process installed."""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "repro_torch"


def _configure(logger: logging.Logger) -> None:
    if logger.handlers:
        return
    level = os.environ.get("REPRO_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    h = logging.StreamHandler(sys.stdout)
    h.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(h)
    logger.propagate = False


def get_logger(name: str = "") -> logging.Logger:
    logger = logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
    _configure(logger)
    return logger
