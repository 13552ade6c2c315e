"""Logging (the port's copy of ``deepspeed_tpu/utils/logging.py``): one
process-wide logger whose level an environment variable can set."""

from __future__ import annotations

import logging
import os
import sys

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name: str = "DeepSpeedTPUTorch",
                   level: int = logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
        lg.addHandler(handler)
    return lg


#: level env override, in priority order; values are the ``log_levels``
#: names (case-insensitive), unknown values fall back to info
LEVEL_ENVS = ("DEEPSPEED_TPU_LOG_LEVEL", "DSTPU_LOG_LEVEL")


def _env_log_level(default: int = logging.INFO) -> int:
    for name in LEVEL_ENVS:
        v = os.environ.get(name)
        if v:
            return log_levels.get(v.strip().lower(), default)
    return default


logger = _create_logger(level=_env_log_level())

_WARNED_ONCE: set = set()


def warning_once(message: str) -> None:
    """Log ``message`` as a warning the first time it is seen."""
    if message not in _WARNED_ONCE:
        _WARNED_ONCE.add(message)
        logger.warning(message)
