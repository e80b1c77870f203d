"""Optimizer base class and registry (counterpart of
``mxnet_tpu/optimizer/optimizer.py``).

Each optimizer defines a pure elementwise rule ``_rule(weight, grad, state,
hp) -> (new_weight, new_state)`` over tensors; `ops.fused_optimizer`
applies it leaf by leaf inside `parallel.TrainStep`.  The base holds the
hyperparameters: the learning rate (or an ``lr_scheduler`` callable of the
update count), weight decay, ``rescale_grad``, ``clip_gradient`` and the
per-index update count ``t``, and the flags (``fused_safe``,
``fused_elementwise``) that tell `ops.fused_optimizer` which of its routes
may run the rule.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "register", "create"]

_registry: Dict[str, type] = {}


def register(cls):
    """Class decorator: make `cls` reachable by `create` under its
    lower-cased name."""
    name = cls.__name__.lower()
    if name in _registry and _registry[name] is not cls:
        raise MXNetError(f"optimizer {name!r} is already registered")
    _registry[name] = cls
    return cls


def create(name, **kwargs):
    """An optimizer by registered name (or the instance itself)."""
    if isinstance(name, Optimizer):
        return name
    try:
        cls = _registry[str(name).lower()]
    except KeyError:
        raise MXNetError(f"unknown optimizer {name!r}; registered: "
                         f"{sorted(_registry)}") from None
    return cls(**kwargs)


class Optimizer:
    """Base optimizer: hyperparameters and the per-index update count.
    Subclasses implement `create_state` and the pure `_rule`.

    ``fused_safe``: the rule is a pure function of its tensors (no host
    state, no host random draws), so `ops.fused_optimizer` may apply it;
    ``fused_elementwise``: the rule is elementwise over (weight, grad,
    state), so it can run over a packed chunk of many leaves."""

    fused_safe = True
    fused_elementwise = False

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=None, lr_scheduler=None, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if self.lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count: Dict[Any, int] = {}

    @property
    def learning_rate(self) -> float:
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr: float):
        self.lr = lr

    def _update_count(self, index) -> int:
        cnt = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = cnt
        self.num_update = max(self.num_update, cnt)
        return cnt

    def hparams(self, index) -> Dict[str, Any]:
        return {"lr": self.learning_rate, "wd": self.wd,
                "rescale_grad": self.rescale_grad,
                "clip_gradient": self.clip_gradient,
                "t": self._index_update_count.get(index, 0)}

    def create_state(self, weight, dtype=None):
        """State tensors shaped like `weight` (in `dtype`, default the
        weight's)."""
        return ()

    @staticmethod
    def _preprocess_grad(grad, hp):
        g = grad * hp["rescale_grad"]
        if hp.get("clip_gradient") is not None:
            g = torch.clamp(g, -hp["clip_gradient"], hp["clip_gradient"])
        return g

    def _rule(self, weight, grad, state, hp):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"
