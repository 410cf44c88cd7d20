"""Leveled logging (parity: vkenv/logger.{c,h} and vksift_setLogLevel,
reference: src/vulkansift/vkenv/logger.c:5-84, vulkansift.c:132-155).

The port's own copy of ``vulkansift_tpu/utils/logging.py``: a thin wrapper
over Python logging with the reference's level enum.
"""

from __future__ import annotations

import enum
import logging

logger = logging.getLogger("vulkansift_tpu_torch")


class LogLevel(enum.Enum):
    NO_LOG = 0
    ERROR = 1
    WARNING = 2
    INFO = 3
    DEBUG = 4


_LEVEL_MAP = {
    LogLevel.NO_LOG: logging.CRITICAL + 10,
    LogLevel.ERROR: logging.ERROR,
    LogLevel.WARNING: logging.WARNING,
    LogLevel.INFO: logging.INFO,
    LogLevel.DEBUG: logging.DEBUG,
}


def set_log_level(level: LogLevel) -> None:
    """Parity: vksift_setLogLevel."""
    logger.setLevel(_LEVEL_MAP[level])
