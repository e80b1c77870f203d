"""Optimizer base class and registry (counterpart of
``mxnet_tpu/optimizer/optimizer.py``).

Each optimizer defines a rule ``_rule(weight, grad, state, hp) ->
(new_weight, new_state)`` over one parameter's tensors (elementwise for
most; per-tensor norms for LARS, LAMB and LANS); `ops.fused_optimizer`
applies it over a whole tree inside `parallel.TrainStep` and
`gluon.Trainer`, and `Optimizer.update` applies it to one parameter (the
`Trainer`'s per-parameter route).  `weak`, `sqrt` and `sign` give the
rules JAX's rounding: weakly typed scalars, correctly rounded roots and
``jnp.sign``.  The base holds the hyperparameters: the
learning rate (or an ``lr_scheduler`` callable of the update count), weight
decay, ``rescale_grad``, ``clip_gradient``, the per-name rate multipliers
(``lr_mult``, ``wd_mult``) and the per-index update count ``t``, and the
flags (``fused_safe``, ``fused_elementwise``) that tell
`ops.fused_optimizer` which of its routes may run the rule.

``multi_precision=True`` gives a 16-bit (f16 or bf16) weight an f32
master copy: `create_state_multi_precision` makes the state ``(w32,
inner)``, the master and the rule's state on it, and
`update_multi_precision` runs the rule on the master with the gradient
cast to f32, then rounds the master into the weight (JAX's
``update_multi_precision``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "register", "create", "weak", "sqrt", "sign"]

_registry: Dict[str, type] = {}


def weak(c, like: torch.Tensor):
    """The Python number `c` as JAX uses it beside `like`: a weakly typed
    scalar takes the array's dtype, so next to a 16-bit tensor it is first
    rounded to 16 bits (``0.9 * bf16_m`` is ``bf16(bf16(0.9) * m)`` in JAX,
    ``bf16(0.9 * m)`` in torch).  f32 and wider: `c` itself; a tensor `c`
    (a device hyperparameter, strongly typed f32 in JAX) passes as it is."""
    if torch.is_tensor(c) or like.dtype.itemsize >= 4:
        return c
    return float(torch.tensor(c, dtype=like.dtype))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sqrt``: the correctly rounded root, as XLA's and CUDA's
    ``sqrtf`` give it.  torch's vectorised CPU kernel can be one ulp off,
    which a rule that cancels large terms (Ftrl's z) would amplify, so on
    the CPU the root is taken in f64 and rounded once (exact for f32 and
    16-bit inputs)."""
    if x.device.type == "cpu" and x.dtype != torch.float64:
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: -1, 1, and `x` itself at +-0 and NaN (``torch.sign``
    gives 0 at NaN)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x)).to(x.dtype)


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

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if self.lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = 0
        self._index_update_count: Dict[Any, int] = {}
        self.param_dict = param_dict or {}
        self.idx2name = param_idx2name or {}
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    # -- rates ------------------------------------------------------------
    def _get_lr(self, index) -> float:
        lr = self.learning_rate
        lr *= self.lr_mult.get(self.idx2name.get(index, index), 1.0)
        if index in self.param_dict:
            lr *= getattr(self.param_dict[index], "lr_mult", 1.0)
        return lr

    def _get_wd(self, index) -> float:
        wd = self.wd * self.wd_mult.get(self.idx2name.get(index, index), 1.0)
        if index in self.param_dict:
            wd *= getattr(self.param_dict[index], "wd_mult", 1.0)
        return wd

    def set_lr_mult(self, args_lr_mult: Dict[Any, float]):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[Any, float]):
        self.wd_mult = dict(args_wd_mult)

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
        return {"lr": self._get_lr(index), "wd": self._get_wd(index),
                "rescale_grad": self.rescale_grad,
                "clip_gradient": self.clip_gradient,
                "t": self._index_update_count.get(index, 0)}

    def create_state(self, weight, dtype=None):
        """State tensors shaped like `weight` (in `dtype`, default the
        weight's)."""
        return ()

    def create_state_multi_precision(self, index, weight) -> tuple:
        """The state of parameter `index`: with ``multi_precision`` and a
        16-bit `weight`, ``(w32, inner)`` -- an f32 copy of the weight and
        the rule's state on it, in f32; otherwise the rule's state in the
        weight's dtype."""
        weight = weight.detach()
        if self.multi_precision and weight.dtype in (torch.float16,
                                                     torch.bfloat16):
            w32 = weight.to(torch.float32)
            return (w32, tuple(self.create_state(w32, dtype=torch.float32)))
        return tuple(self.create_state(weight, dtype=weight.dtype))

    def _is_mp_state(self, weight, state) -> bool:
        """`state` is `create_state_multi_precision`'s ``(w32, inner)``
        for a weight that is not f32."""
        return (self.multi_precision and isinstance(state, tuple)
                and len(state) == 2 and torch.is_tensor(state[0])
                and state[0].dtype == torch.float32
                and weight.dtype != torch.float32
                and isinstance(state[1], tuple))

    @staticmethod
    def _preprocess_grad(grad, hp):
        g = grad * weak(hp["rescale_grad"], grad)
        if hp.get("clip_gradient") is not None:
            g = torch.clamp(g, -hp["clip_gradient"], hp["clip_gradient"])
        return g

    def _rule(self, weight, grad, state, hp):
        raise NotImplementedError

    @torch.no_grad()
    def update(self, index, weight, grad, state) -> tuple:
        """One step of parameter `index`: the rule on the stored dtypes
        with Python-number hyperparameters (``hparams``), as JAX's
        ``Optimizer.update`` runs it, the results cast back to the stored
        dtypes.  The weight and each state tensor are updated in place;
        returns the state tuple, in which a slot whose shape the rule
        changes is the rule's new tensor (DCASGD's 0-d momentum becomes
        the weight's shape, as JAX rebinds it)."""
        self._update_count(index)
        nw, ns = self._rule(weight, grad, tuple(state), self.hparams(index))
        out = _write_back(state, ns)
        weight.copy_(nw)
        return out

    @torch.no_grad()
    def update_multi_precision(self, index, weight, grad, state) -> tuple:
        """One step of parameter `index` (the `Trainer`'s per-parameter
        route).  With a ``(w32, inner)`` state (`_is_mp_state`) the rule
        runs on the f32 master with the gradient cast to f32, the master
        and `inner` are updated in place and the weight becomes the master
        rounded to its dtype; otherwise `update`.  Returns the state."""
        if not self._is_mp_state(weight, state):
            return self.update(index, weight, grad, state)
        w32, inner = state
        self._update_count(index)
        nw, ns = self._rule(w32, grad.to(torch.float32), tuple(inner),
                            self.hparams(index))
        inner = _write_back(inner, ns)
        w32.copy_(nw)
        weight.copy_(nw)
        return (w32, inner)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


def _write_back(state, new) -> tuple:
    """The rule's new state tensors written into `state`'s in place (cast
    to their dtypes); a slot whose shape the rule changed is the rule's
    new tensor instead (DCASGD's 0-d momentum becomes the weight's shape,
    as JAX rebinds it)."""
    out = []
    for old, nw in zip(state, new):
        if old.shape == nw.shape:
            old.copy_(nw)
            out.append(old)
        else:
            out.append(nw.to(old.dtype))
    return tuple(out)
