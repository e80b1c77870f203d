"""Carry weights and optimizer state from the JAX package into the port.

`load_jax_params` takes the JAX model's parameters as a plain dict of
numpy arrays — ``{name: p.data().asnumpy() for name, p in
jax_model.collect_params().items()}`` — and fills the port's module, whose
parameter tree uses the same names.  Nothing of the JAX package is
imported here: the dict is the interface.

It carries `GPTForCausalLM`, `BertForPretraining` and `TransformerNMT`
alike, in f32, bf16 or f16, unchanged: each port module's tree carries
the Gluon names of its JAX counterpart.  A bf16 or f16 model keeps its
LayerNorm gains and biases in f32, as Gluon does, so the dtype check
passes leaf by leaf (numpy's float16 arrays pass through as they are).
Build the port's model on the device it will run on: the dropout
generator of a `BertForPretraining` stays on the device it was built
for.

`load_jax_optimizer_states` does the same for a JAX `gluon.Trainer`'s
optimizer state (``{name: tuple of numpy arrays}``, as its ``_states``
holds them or its `Updater` pickles them) and its update counts, into the
port's `gluon.Trainer`, so a run started in JAX continues in the port.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch

from .base import MXNetError
from .device import resolve_device
from .gluon.block import Block
from .gluon.parameter import Parameter
from .util import to_tensor

__all__ = ["load_jax_params", "load_jax_optimizer_states"]


def load_jax_params(model: torch.nn.Module, params: Dict[str, np.ndarray],
                    device=None) -> torch.nn.Module:
    """Copy `params` into `model` name for name (its Gluon
    `collect_params()` names; a parameter not initialized yet takes the
    value as it comes), then place the model on `device` (the card unless
    ``device="cpu"``).  Raises `MXNetError` on a missing or extra name, or
    a shape or dtype that differs; nothing is copied unless every entry
    checks out.  Returns `model`."""
    dev = resolve_device(device)
    own = OrderedDict()
    _leaves(model, own, "")
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise MXNetError(
            f"load_jax_params: parameter names differ — missing "
            f"{missing or 'none'}, extra {extra or 'none'}")
    for name, arr in params.items():
        p = own[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise MXNetError(
                f"load_jax_params: {name} is {tuple(arr.shape)} in the "
                f"source, {tuple(p.shape)} in the model")
        if str(np.dtype(arr.dtype)) != str(p.dtype).replace("torch.", ""):
            raise MXNetError(
                f"load_jax_params: {name} is {np.dtype(arr.dtype)} in the "
                f"source, {p.dtype} in the model")
    with torch.no_grad():
        for name, arr in params.items():
            p = own[name]
            if isinstance(p, Parameter):
                if p._data is None:
                    p._install(to_tensor(arr).clone())
                    continue
                p = p._data
            p.copy_(to_tensor(arr))
    return model.to(dev)


def _leaves(module, out, prefix):
    """`module`'s parameters by dotted name: a Gluon block's `Parameter`s
    (initialized or not), a plain module's tensors."""
    if isinstance(module, Block):
        for name, p in module._reg_params.items():
            out[prefix + name] = p
    else:
        for name, t in module._parameters.items():
            if t is not None:
                out[prefix + name] = t
    for cname, child in module._modules.items():
        if child is not None:
            _leaves(child, out, prefix + cname + ".")


def _state_slots(opt, name, st, want, p) -> tuple:
    """JAX's state tuple `st` (numpy arrays) as tensors on `p`'s device,
    checked slot by slot against the port's `want`."""
    st = tuple(st or ())
    if len(st) != len(want):
        raise MXNetError(
            f"load_jax_optimizer_states: {name} has {len(st)} state "
            f"tensors, {type(opt).__name__} keeps {len(want)}")
    slots = []
    for k, (arr, ref) in enumerate(zip(st, want)):
        shape = tuple(np.shape(arr))
        if shape not in (tuple(ref.shape), tuple(p.shape)):
            raise MXNetError(
                f"load_jax_optimizer_states: {name} state {k} is "
                f"{shape}, the port's {tuple(ref.shape)}")
        t = to_tensor(arr)
        if t.dtype != ref.dtype:
            raise MXNetError(
                f"load_jax_optimizer_states: {name} state {k} is "
                f"{t.dtype}, the port keeps {ref.dtype}")
        slots.append(t.to(p.device))
    return tuple(slots)


def load_jax_optimizer_states(trainer, states: Dict[str, Any],
                              num_update: int,
                              index_update_count: Optional[Dict] = None):
    """Give the port's `gluon.Trainer` a JAX `Trainer`'s optimizer state:
    `states` maps each parameter name to its state tuple (numpy arrays; an
    empty tuple or None for a rule without state, such as Signum or LARS
    without momentum), `num_update` is JAX's ``optimizer.num_update`` and
    `index_update_count` its per-name counts (each `num_update` when not
    given).  Each slot must have the shape of the slot the port's rule
    creates -- or the weight's, where JAX's rule has made it so (DCASGD's
    0-d momentum after a step) -- and the weight's dtype (the `Trainer`
    keeps its state there).  Under ``multi_precision=True`` a 16-bit
    weight's state is JAX's pair ``(w32, inner)``: the f32 master copy, of
    the weight's shape, and the rule's state tuple on it, in f32.  Nothing
    is changed unless every entry checks out.  The states go to the
    weights' device."""
    opt = trainer.optimizer
    params = dict(zip(trainer._param_names, trainer._params))
    missing = sorted(set(params) - set(states))
    extra = sorted(set(states) - set(params))
    if missing or extra:
        raise MXNetError(
            f"load_jax_optimizer_states: parameter names differ — missing "
            f"{missing or 'none'}, extra {extra or 'none'}")
    out = {}
    for name, st in states.items():
        p = params[name].detach()
        want = opt.create_state_multi_precision(name, p)
        if opt._is_mp_state(p, want):
            if not (isinstance(st, (tuple, list)) and len(st) == 2 and
                    isinstance(st[1], (tuple, list))):
                raise MXNetError(
                    f"load_jax_optimizer_states: {name} is a "
                    f"multi-precision weight; its state is (w32, inner)")
            w32 = _state_slots(opt, name, (st[0],), (want[0],), p)
            out[name] = w32 + (_state_slots(opt, name, st[1], want[1], p),)
        else:
            out[name] = _state_slots(opt, name, st, want, p)
    trainer._states = out
    opt.num_update = int(num_update)
    opt._index_update_count = dict(index_update_count) if \
        index_update_count is not None else \
        {n: int(num_update) for n in params}
    return trainer
