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
           "check_x64_dtype", "unported", "UnportedModule",
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


def check_x64_dtype(dtype) -> None:
    """Raise when a 64-bit float or complex dtype is asked for explicitly.

    The port has no 64-bit switch: it keeps the JAX package's rule with
    ``MXTPU_ENABLE_X64`` off, under which a float64 request would silently
    become float32 — so it raises instead.  int64 is not checked: integer
    width narrows to 32 bits, as ``jnp.asarray`` does with x64 off."""
    if dtype is None:
        return
    name = str(dtype).replace("torch.", "") if not isinstance(dtype, str) \
        else dtype
    if name not in ("float64", "complex128", "double", "cdouble"):
        try:
            import numpy as _np
            name = _np.dtype(dtype).name
        except (TypeError, ValueError):
            return
    if name in ("float64", "complex128", "double", "cdouble"):
        raise MXNetError(
            f"dtype {name} requested, but the port has no 64-bit float "
            "support (it would silently truncate to float32); use float32")


def unported(name: str, item: str):
    """A stand-in for `name`, which the port does not have yet: calling
    it raises `MXNetError` naming ROADMAP.md's item `item`."""
    def fn(*args, **kwargs):
        raise MXNetError(f"{name} is not ported yet (ROADMAP.md {item})")
    fn.__name__ = fn.__qualname__ = name.rsplit(".", 1)[-1]
    fn.__doc__ = f"Not ported yet: raises `MXNetError` (ROADMAP.md {item})."
    fn.roadmap_item = item
    return fn


class UnportedModule:
    """A stand-in for a namespace the port does not have yet (``mx.np.
    linalg``, ``mx.nd.sparse``): reading any name of it raises
    `MXNetError` naming ROADMAP.md's item."""

    def __init__(self, name: str, item: str):
        self.__name__ = name
        self.roadmap_item = item

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise MXNetError(f"{self.__name__}.{attr} is not ported yet "
                         f"(ROADMAP.md {self.roadmap_item})")

    def __repr__(self):
        return f"<unported {self.__name__} (ROADMAP.md {self.roadmap_item})>"
