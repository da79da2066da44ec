"""Verbosity-gated logging (counterpart of solr_tpu/utils/logging.py;
reference: solr/Logging.h, LOG_INFO(level, msg) / LOG_WARNING /
LOG_ERROR gated by a global level).

One namespaced logger, ``solr_tpu_torch``, with the reference's three
severities and the numeric info-verbosity gate of its LOG_INFO(level,
...) macro.  ``SOLR_LOG_LEVEL`` sets the gate at import (default 1).
"""

from __future__ import annotations

import logging
import os
import sys

__all__ = ["get_logger", "set_verbosity", "log_info", "log_warning",
           "log_error"]

_LOGGER = logging.getLogger("solr_tpu_torch")
_INFO_VERBOSITY = int(os.environ.get("SOLR_LOG_LEVEL", "1"))

if not _LOGGER.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter(
        "[solr_tpu_torch %(levelname).1s %(asctime)s] %(message)s",
        datefmt="%H:%M:%S"))
    _LOGGER.addHandler(_handler)
    _LOGGER.setLevel(logging.INFO)
    _LOGGER.propagate = False


def get_logger() -> logging.Logger:
    return _LOGGER


def set_verbosity(level: int) -> None:
    """Info messages with ``level`` above this are dropped (reference:
    the compile-time verbosity gate on LOG_INFO)."""
    global _INFO_VERBOSITY
    _INFO_VERBOSITY = int(level)


def log_info(level: int, msg: str, *args) -> None:
    if level <= _INFO_VERBOSITY:
        _LOGGER.info(msg, *args)


def log_warning(msg: str, *args) -> None:
    _LOGGER.warning(msg, *args)


def log_error(msg: str, *args) -> None:
    _LOGGER.error(msg, *args)
