"""Updater — per-key optimizer state (counterpart of
``mxnet_tpu/optimizer/updater.py``).  `gluon.Trainer` saves and loads its
optimizer state through `get_states` / `set_states`."""
from __future__ import annotations

import pickle
from typing import Dict

import torch

from .optimizer import Optimizer

__all__ = ["Updater"]


def _to_cpu(s):
    if torch.is_tensor(s):
        return s.detach().cpu()
    if isinstance(s, (tuple, list)):
        return tuple(_to_cpu(x) for x in s)
    return s


class Updater:
    """An optimizer and its per-key states (``states``).  Stepping keys
    through the updater (the kvstore's server-side update) waits for the
    kvstore (ROADMAP.md)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict = {}

    def get_states(self, dump_optimizer: bool = False) -> bytes:
        """The states (as CPU tensors), and the optimizer with its step
        counts when `dump_optimizer`, as one pickled blob."""
        states = {k: _to_cpu(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)

    def set_states(self, states_blob: bytes) -> None:
        """Load a `get_states` blob; a dumped optimizer replaces
        ``self.optimizer``.  The states stay on the CPU: the caller moves
        them to its weights' device."""
        data = pickle.loads(states_blob)
        if isinstance(data, tuple) and len(data) == 2 and \
                isinstance(data[1], Optimizer):
            states, self.optimizer = data
        else:
            states = data
        self.states = {k: tuple(v) if isinstance(v, (tuple, list)) else v
                       for k, v in states.items()}
