"""Errors and environment helpers (the port's own copy of the parts of
``mxnet_tpu/base.py`` it needs)."""
from __future__ import annotations

import os

__all__ = ["MXNetError", "env_int", "env_str"]


class MXNetError(RuntimeError):
    """Error raised by the framework."""


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)
