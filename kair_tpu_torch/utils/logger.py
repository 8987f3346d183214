"""Logging setup: file + console handlers, idempotent per name
(counterpart of ``kair_tpu/utils/logger.py``; reference
utils/utils_logger.py:42-81)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def setup_logger(name: str, log_path: Optional[str] = None,
                 level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s.%(msecs)03d : %(message)s",
                            datefmt="%y-%m-%d %H:%M:%S")
    if log_path:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        fh = logging.FileHandler(log_path, mode="a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    logger.propagate = False
    return logger


_WARNED: set = set()


def warn_once(key: str, message: str) -> None:
    """Emit ``message`` once per process for each distinct ``key`` — e.g. a
    fused kernel path not taken for an unsupported geometry, logged once
    per (site, geometry)."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    logging.getLogger("kair_tpu_torch").warning(message)
