"""Foundation utilities of the PyTorch port: the framework error and the
environment-flag helpers the serving slice reads.

A copy of what the slice needs from ``mxnet_tpu/base.py`` — the port never
imports the JAX package, not even its JAX-free modules.
"""
from __future__ import annotations

import os

__all__ = ["MXNetError", "getenv_bool", "getenv_int"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: dmlc::Error / MXNetError)."""


def getenv_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


def getenv_int(name: str, default: int = 0) -> int:
    """Integer env flag; unset, empty or malformed values give `default`."""
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default
