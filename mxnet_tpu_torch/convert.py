"""Carry weights from the JAX package into the port.

`load_jax_params` takes the JAX model's parameters as a plain dict of
numpy arrays — ``{name: p.data().asnumpy() for name, p in
jax_model.collect_params().items()}`` — and fills the port's module, whose
parameter tree uses the same names.  Nothing of the JAX package is
imported here: the dict is the interface.

It carries `GPTForCausalLM`, `BertForPretraining` and `TransformerNMT`
alike, in f32 or bf16, unchanged: each port module's tree carries the
Gluon names of its JAX counterpart.  A bf16 model keeps its LayerNorm
gains and biases in f32, as Gluon does, so the dtype check passes leaf by
leaf.  Build the port's model on
the device it will run on: the dropout generator of a `BertForPretraining`
stays on the device it was built for.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import MXNetError
from .device import resolve_device

__all__ = ["load_jax_params"]


def load_jax_params(model: torch.nn.Module, params: Dict[str, np.ndarray],
                    device=None) -> torch.nn.Module:
    """Copy `params` into `model` name for name, then place the model on
    `device` (the card unless ``device="cpu"``).  Raises `MXNetError` on a
    missing or extra name, or a shape or dtype that differs; nothing is
    copied unless every entry checks out.  Returns `model`."""
    dev = resolve_device(device)
    own = dict(model.named_parameters())
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
            src = np.asarray(arr)
            if src.dtype.name == "bfloat16":
                # numpy has no bfloat16: go through float32, which holds
                # every bfloat16 value exactly
                t = torch.from_numpy(src.astype(np.float32)).to(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(src))
            own[name].copy_(t)
    return model.to(dev)
