"""Random numbers of the port (counterpart of ``mxnet_tpu/random.py``).

`seed` sets one explicit ``torch.Generator`` a device (`generator`), which
the initializers and Gluon's `Dropout` draw from, and torch's own default
generators too, so plain modules inside a Gluon net (the models' dropout)
follow the same seed.  JAX's keyed PRNG cannot be matched bit for bit:
parity here is determinism from a seed within the port, plus the
distributions.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

from .device import as_torch_device

__all__ = ["seed", "generator", "generator_scope"]

_lock = threading.Lock()
_seed = [0]
_gens: Dict[torch.device, torch.Generator] = {}
_scoped = threading.local()


def _key(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(seed_state: int, ctx="all") -> None:
    """Seed every device's generator (``ctx="all"``), or only `ctx`'s."""
    s = int(seed_state)
    with _lock:
        if ctx in (None, "all"):
            _seed[0] = s
            _gens.clear()
            torch.manual_seed(s)
            return
        dev = _key(as_torch_device(ctx))
        _gens[dev] = torch.Generator(device=dev).manual_seed(s)


def generator(device=None) -> torch.Generator:
    """The generator of `device` (a tensor's device, a `Device` or a
    string; None: the current device), made from the seed at first use."""
    dev = device if isinstance(device, torch.device) else \
        as_torch_device(device)
    dev = _key(dev)
    scoped = getattr(_scoped, "gens", None)
    if scoped is not None:
        if dev not in scoped:
            scoped[dev] = torch.Generator(device=dev).manual_seed(
                _scoped.seed)
        return scoped[dev]
    with _lock:
        g = _gens.get(dev)
        if g is None:
            g = _gens[dev] = torch.Generator(device=dev).manual_seed(
                _seed[0])
        return g


@contextlib.contextmanager
def generator_scope(seed_state: int):
    """Within the scope every `generator` is a fresh one seeded with
    `seed_state` (the port's counterpart of JAX's ``key_scope``)."""
    prev = getattr(_scoped, "gens", None), getattr(_scoped, "seed", None)
    _scoped.gens, _scoped.seed = {}, int(seed_state)
    try:
        yield
    finally:
        _scoped.gens, _scoped.seed = prev
