"""Optimizer update over a whole parameter tree (counterpart of
``mxnet_tpu/ops/pallas/fused_optimizer.py``, its reference half).

`apply_updates` runs the optimizer's elementwise `_rule` leaf by leaf,
casts the new weight and state back to their stored dtypes, and with a
`skip` flag turns the whole update into the identity — the semantics of
the JAX package's ``_reference_leaf`` (:94-108), which is the path its
``MXTPU_PALLAS=reference`` setting takes.  The multi-tensor chunk kernel
(``_run_elementwise_chunk``) and the LAMB kernels come in a later slice,
in this file.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

__all__ = ["apply_updates"]


def _cast_like(new, old):
    return new.to(old.dtype) if new.dtype != old.dtype else new


def _reference_leaf(optimizer, w, g, s_old, hp, skip):
    # the hyperparameters are f32 tensors; in JAX they promote a 16-bit
    # leaf's update math to f32 (torch's 0-dim tensors would not), so the
    # rule runs on f32 views of the weight and gradient
    dt = torch.promote_types(w.dtype, torch.float32)
    nw, ns = optimizer._rule(w.to(dt), g.to(dt), s_old, hp)
    nw = _cast_like(nw, w)
    ns = tuple(_cast_like(n, o) for n, o in zip(ns, s_old))
    if skip is not None:
        # the whole update becomes the identity: weight and state keep
        # their pre-step values
        nw = torch.where(skip, w, nw)
        ns = tuple(torch.where(skip, o, n) for n, o in zip(ns, s_old))
    return nw, ns


def apply_updates(optimizer, params: Dict[str, Any], grads: Dict[str, Any],
                  states: Dict[str, Any], hp: Dict[str, Any], skip=None
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One optimizer step over name-keyed trees: params/grads ``{name:
    tensor}``, states ``{name: tuple of tensors}`` from
    ``optimizer.create_state``; hp the scalar dict (lr, wd, rescale_grad,
    clip_gradient, t); skip an optional bool tensor — True keeps every
    weight and state bit-exactly.  Returns (new params, new states)."""
    out_p, out_s = {}, {}
    for n in sorted(params):
        out_p[n], out_s[n] = _reference_leaf(optimizer, params[n], grads[n],
                                             states[n], hp, skip)
    return out_p, out_s
