"""Automatic mixed precision (counterpart of ``mxnet_tpu/amp/``; parity:
`python/mxnet/amp/`).

`init` turns on the cast hook `cast_inputs`, which the port's op entry
points call under the JAX package's ``apply_op`` names
(``fully_connected``, ``layer_norm``, ``multi_head_attention``, ...): from
then on each such call casts its float inputs by the lists (`lists`) --
TARGET ops to the AMP dtype, FP32 ops to f32, WIDEST ops to the widest
float among their inputs -- with JAX's precedence (`_cast_args_for_op`).
The casts are ``Tensor.to``, so autograd casts each gradient back to its
input's dtype, as JAX's ``convert_element_type`` transpose does.  With AMP
off the hook returns its inputs untouched after one check.

float16 comes with a dynamic loss scaler (`LossScaler`): `init_trainer`
attaches it to a `gluon.Trainer`, `scale_loss` multiplies the loss by the
scale, and `Trainer.step` skips any step whose gradients overflowed,
shrinking the scale, and divides the scale back out of the others.
bfloat16 needs no scaler.  `convert_hybrid_block` casts a module's float
parameters (train it with ``multi_precision=True`` for f32 master
copies).

``convert_symbol`` and ``convert_model`` rewrite a `Symbol` graph, which
the port does not have yet: they raise `MXNetError` naming ROADMAP.md's
item A16.
"""
from __future__ import annotations

import functools

import torch

from ..base import MXNetError
from .lists import (CONDITIONAL_FP32_OPS, FP16_FP32_FUNCS, FP16_FP32_OPS,
                    FP16_FUNCS, FP32_FUNCS, FP32_OPS, TARGET_DTYPE_OPS,
                    WIDEST_TYPE_CASTS)
from .loss_scaler import LossScaler

__all__ = ["init", "disable", "cast_inputs", "init_trainer", "scale_loss",
           "unscale", "convert_hybrid_block", "convert_symbol",
           "convert_model", "LossScaler", "mixed_precision_dtype",
           "list_lp16_ops", "list_fp32_ops", "list_lp16_fp32_ops",
           "list_conditional_fp32_ops", "list_widest_type_cast",
           "list_loss_output_functions", "list_lp16_use_fp32_params",
           "CONDITIONAL_FP32_OPS", "FP16_FP32_FUNCS", "FP16_FUNCS",
           "FP32_FUNCS", "FP32_OPS", "TARGET_DTYPE_OPS",
           "WIDEST_TYPE_CASTS"]

_state = {"enabled": False, "dtype": torch.bfloat16, "scaler": None,
          "user_fp32": set(), "user_target": set(), "conditional": {}}

_TARGET = set(TARGET_DTYPE_OPS)
_FP32 = set(FP32_OPS)
_WIDEST = set(WIDEST_TYPE_CASTS)


def _dtype(target_dtype) -> torch.dtype:
    return torch.bfloat16 if str(target_dtype).replace("torch.", "") in (
        "bfloat16", "bf16") else torch.float16


def _is_float(v) -> bool:
    return torch.is_tensor(v) and v.is_floating_point()


def _cast_args_for_op(name, vals, kwargs):
    """The cast policy (JAX's ``_cast_args_for_op``; reference: amp_cast
    insertion in `src/nnvm/low_precision_pass.cc`).  Returns the op's
    inputs with the float ones cast per its list membership; others
    untouched.

    Precedence: user target_precision_ops > fp32 lists > default target
    list > widest-cast > conditional (attribute-keyed) entries."""
    if name in _state["user_target"]:
        tgt = _state["dtype"]
    elif name in _FP32 or name in _state["user_fp32"]:
        tgt = torch.float32
    elif name in _TARGET:
        tgt = _state["dtype"]
    elif name in _WIDEST:
        floats = [v.dtype for v in vals if _is_float(v)]
        if len(floats) < 2:
            return vals
        tgt = functools.reduce(torch.promote_types, floats)
    else:
        cond = _state["conditional"]
        if name not in cond:
            return vals
        attr, bad = cond[name]
        if str(kwargs.get(attr)) not in bad:
            return vals
        tgt = torch.float32
    return [v.to(tgt) if _is_float(v) and v.dtype != tgt else v
            for v in vals]


def cast_inputs(name, *tensors, **attrs):
    """The hook: `tensors` (any of them may be None or a non-float) as op
    `name` takes them under AMP, as a tuple.  Off, the inputs as given.
    `attrs` are the op's attributes a conditional entry may key on."""
    if not _state["enabled"]:
        return tensors
    return tuple(_cast_args_for_op(name, list(tensors), attrs))


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP; `target_dtype` is "bfloat16" or "float16".

    `target_precision_ops` forces extra ops into the target dtype
    (overriding the fp32 lists); `fp32_ops` adds ops to the fp32 list;
    `conditional_fp32_ops` adds ``(op, attr, [values])`` routes to fp32
    for calls whose attribute `attr` takes one of `values`.  float16
    creates a fresh `LossScaler` for `init_trainer`; bfloat16 retires any
    earlier one (a Trainer holding it stops scaling)."""
    dt = _dtype(target_dtype)
    cond = dict(CONDITIONAL_FP32_OPS)
    for op, attr, values in (conditional_fp32_ops or ()):
        cond[op] = (attr, [str(v) for v in values])
    old = _state["scaler"]
    if old is not None and dt != torch.float16:
        old.active = False
    _state.update(enabled=True, dtype=dt, user_fp32=set(fp32_ops or ()),
                  user_target=set(target_precision_ops or ()),
                  conditional=cond,
                  scaler=LossScaler() if dt == torch.float16 else None)


def mixed_precision_dtype():
    """The AMP dtype while AMP is on, else None."""
    return _state["dtype"] if _state["enabled"] else None


def disable():
    """Turn AMP off (the hook passes inputs through again).  Scalers
    already attached to Trainers deactivate in place."""
    old = _state["scaler"]
    if old is not None:
        old.active = False
    _state.update(enabled=False, scaler=None)


def init_trainer(trainer):
    """Attach the dynamic loss scaler to a `gluon.Trainer` (float16
    only)."""
    if _state["scaler"] is not None:
        trainer._amp_loss_scaler = _state["scaler"]


class scale_loss:
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``:
    the loss (or each of a list) times the trainer's loss scale; the loss
    itself without a scaler."""

    def __init__(self, loss, trainer):
        self._loss = loss
        self._trainer = trainer

    def __enter__(self):
        scaler = getattr(self._trainer, "_amp_loss_scaler", None)
        if scaler is None:
            return self._loss
        if isinstance(self._loss, (list, tuple)):
            return [l * scaler.loss_scale for l in self._loss]
        return self._loss * scaler.loss_scale

    def __exit__(self, *exc):
        return False


@torch.no_grad()
def unscale(trainer):
    """Divide the loss scale out of the trainer's gradients in place."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    scale = 1.0 / scaler.loss_scale
    for p in trainer._params:
        if p.grad is not None:
            p.grad.mul_(scale)


def convert_hybrid_block(block, target_dtype="bfloat16",
                         target_dtype_ops=None, fp32_ops=None,
                         conditional_fp32_ops=None, excluded_sym_names=None,
                         device=None, cast_params_offline=False):
    """Cast every float parameter (and float buffer) of the `nn.Module`
    `block` to the AMP dtype in place, as JAX's ``Block.cast`` casts every
    `Parameter`; returns `block`.  The parameter objects stay the same, so
    a `Trainer` built before or after sees them; each Gluon `Parameter`
    takes the dtype of its new value (one not initialized yet, the AMP
    dtype if it is a float)."""
    from ..gluon.block import Block
    dt = _dtype(target_dtype)
    block.to(dt)
    for m in block.modules():
        if isinstance(m, Block):
            for p in m._reg_params.values():
                if p._data is not None:
                    p.dtype = p._data.dtype
                elif p.dtype.is_floating_point:
                    p.dtype = dt
    return block


def _needs_symbol(what):
    return MXNetError(f"amp.{what} rewrites a Symbol graph, which the port "
                      f"does not have yet (ROADMAP.md, A16)")


def convert_symbol(sym, target_dtype="bfloat16", target_dtype_ops=None,
                   fp32_ops=None, conditional_fp32_ops=None,
                   excluded_sym_names=None, data_names=None,
                   cast_optional_params=False):
    """Not ported: raises `MXNetError` naming A16 (`Symbol`)."""
    raise _needs_symbol("convert_symbol")


def convert_model(sym, arg_params, aux_params, input_dtypes=None,
                  target_dtype="bfloat16", target_dtype_ops=None,
                  fp32_ops=None, conditional_fp32_ops=None,
                  excluded_sym_names=None, cast_params_offline=False):
    """Not ported: raises `MXNetError` naming A16 (`Symbol`)."""
    raise _needs_symbol("convert_model")


# -- list accessors (parity: `amp.py` list_lp16_ops & friends) -----------

def list_lp16_ops(target_dtype="bfloat16"):
    """Ops that run in the low-precision dtype (the TARGET list)."""
    return list(TARGET_DTYPE_OPS)


def list_fp32_ops(target_dtype="bfloat16"):
    """Ops pinned to float32."""
    return list(FP32_OPS)


def list_lp16_fp32_ops(target_dtype="bfloat16"):
    """Ops that can run in either dtype (no forced cast)."""
    return list(FP16_FP32_OPS)


def list_conditional_fp32_ops(target_dtype="bfloat16"):
    """[(op, attr, values)] routes forced to fp32 when the attr matches."""
    return [(op, attr, list(values))
            for op, (attr, values) in CONDITIONAL_FP32_OPS.items()]


def list_widest_type_cast(target_dtype="bfloat16"):
    """Multi-input ops cast to the widest input dtype."""
    return list(WIDEST_TYPE_CASTS)


def list_loss_output_functions(target_dtype="bfloat16"):
    """Loss outputs kept in fp32: every gluon loss."""
    from ..gluon import loss as _loss
    return [n for n in _loss.__all__ if n.endswith("Loss")]


def list_lp16_use_fp32_params(target_dtype="bfloat16"):
    """Ops that take lp16 activations but keep fp32 params: none."""
    return []
