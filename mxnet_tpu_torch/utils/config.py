"""The port's flags, each overridable from the environment as
``MXTPU_<NAME>`` (or MXNet's ``MXNET_<NAME>``) — counterpart of
``mxnet_tpu/utils/config.py``.  Only the flags the port reads are here."""
from __future__ import annotations

import dataclasses
import os

__all__ = ["Flags", "flags"]


def _env(name: str, legacy: str, default: str) -> str:
    for key in (f"MXTPU_{name}", legacy):
        if key in os.environ:
            return os.environ[key]
    return default


@dataclasses.dataclass
class Flags:
    # MXNet's engine type, as `engine.engine_type()` reports it; the port's
    # engine is torch's CUDA streams
    engine_type: str = _env("ENGINE_TYPE", "MXNET_ENGINE_TYPE", "cuda")


flags = Flags()
