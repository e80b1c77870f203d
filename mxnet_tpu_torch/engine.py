"""The engine's controls (counterpart of ``mxnet_tpu/engine.py``).

MXNet's dependency engine schedules every op asynchronously; on the card
torch's CUDA streams do that, so `waitall` is a synchronize of every card
in use and the bulking knobs are accepted and do nothing."""
from __future__ import annotations

import contextlib

import torch

from .utils.config import flags

__all__ = ["waitall", "engine_type", "bulk", "set_bulk_size"]


def waitall():
    """Wait for all work queued on the cards (``Engine::WaitForAll``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def engine_type() -> str:
    return flags.engine_type


def set_bulk_size(size: int) -> int:
    """MXNet's ``set_bulk_size``, accepted: torch queues each op on its
    stream, so there is nothing to bulk.  Returns 0, the size in force."""
    return 0


@contextlib.contextmanager
def bulk(size: int):
    """MXNet's ``bulk`` scope, accepted (see `set_bulk_size`)."""
    yield
