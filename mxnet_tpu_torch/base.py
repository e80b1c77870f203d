"""Foundation utilities of the PyTorch port: the framework error, the
environment-flag helpers the serving slice reads and the name registry the
initializers and metrics register under.

A copy of what the slice needs from ``mxnet_tpu/base.py`` — the port never
imports the JAX package, not even its JAX-free modules.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

__all__ = ["MXNetError", "SuspectedHostLoss", "getenv_bool", "getenv_int",
           "Registry"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: dmlc::Error / MXNetError)."""


class SuspectedHostLoss(MXNetError):
    """A bounded multi-process coordination round (flag sync, step
    consensus) timed out: the most likely cause is a peer that died or was
    preempted mid-collective.  Subclasses `MXNetError` so die-and-restart
    handling still applies, but carries the diagnosis."""


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


class Registry:
    """Name -> object registry with decorator registration (the JAX
    package's ``base.Registry``); names are case-insensitive."""

    def __init__(self, name: str):
        self.name = name
        self._store: Dict[str, object] = {}

    def register(self, obj=None, name: Optional[str] = None, *, aliases=()):
        def _do(o, nm):
            self._store[(nm or o.__name__).lower()] = o
            for a in aliases:
                self._store[a.lower()] = o
            return o

        if obj is None:
            return lambda o: _do(o, name)
        return _do(obj, name)

    def get(self, name: str):
        key = name.lower()
        if key not in self._store:
            raise MXNetError(f"{self.name} '{name}' is not registered. "
                             f"Available: {sorted(self._store)}")
        return self._store[key]
