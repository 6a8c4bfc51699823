"""Namespaced logger factory — the port's copy of
``mmlspark_tpu/core/logging_utils.py``: the port's loggers live under
``mmlspark_tpu_torch.*``."""

from __future__ import annotations

import logging

NAMESPACE = "mmlspark_tpu_torch"


def get_logger(name: str | None = None) -> logging.Logger:
    return logging.getLogger(f"{NAMESPACE}.{name}" if name else NAMESPACE)
