"""Basic Gluon layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``).

Each layer computes what its JAX counterpart's ``npx`` op computes, through
the port's `ops.nn`: `Dense` is ``fully_connected`` (``flatten=True`` by
default, as JAX's), `LayerNorm` and `RMSNorm` go through the fused-norm
dispatcher (the norm kernel on the card), `Dropout` draws its mask from its
`generator` (by default `random.generator` of the input's device) and is on
only under `autograd.is_training`, and `BatchNorm` keeps MXNet's running
statistics (`ops.nn.batch_norm`).

`LayerNorm` keeps the function it normalises the last axis with in
``_norm`` (`ops.nn.layer_norm`) and the pre-LN residual step a GPT block
calls in ``_norm_residual`` (`ops.nn.layer_norm_residual`); `RMSNorm` its
``_norm`` (`ops.nn.rms_norm`).  A model's plain twin swaps them for the
fused norm's plain versions (`models.layers`).
"""
from __future__ import annotations

import numpy as np
import torch

from ...base import MXNetError
from ... import autograd as _ag
from ... import random as _rng
from ...ops import nn as F
from ..block import Block, HybridBlock
from ..parameter import Parameter

__all__ = [
    "Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
    "BatchNorm", "BatchNormReLU", "SyncBatchNorm", "LayerNorm", "RMSNorm",
    "GroupNorm", "InstanceNorm", "Flatten", "Lambda", "HybridLambda",
    "Concatenate", "HybridConcatenate", "Identity", "Activation",
]


class _SequentialMixin:
    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def forward(self, x, *args):
        for b in self._child_blocks():
            x = b(x, *args)
            args = ()
        return x

    def __getitem__(self, key):
        items = self._child_blocks()
        if isinstance(key, slice):
            net = type(self)()
            for b in items[key]:
                net.add(b)
            return net
        return items[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._child_blocks())


class Sequential(_SequentialMixin, Block):
    """Stack of blocks run in order."""

    def __init__(self, *blocks):
        super().__init__()
        self.add(*blocks)


class HybridSequential(_SequentialMixin, HybridBlock):
    def __init__(self, *blocks):
        super().__init__()
        self.add(*blocks)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act = activation

    def forward(self, x):
        return F.activation(x, act_type=self._act)

    def extra_repr(self):
        return self._act


class Dense(HybridBlock):
    """Fully connected layer: weight (units, in_units), ``in_units``
    deferred to the first input when 0."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.act = Activation(activation) if activation else None
        self.weight = Parameter("weight", shape=(units, in_units),
                                dtype=dtype, init=weight_initializer,
                                allow_deferred_init=True)
        self.bias = Parameter("bias", shape=(units,), dtype=dtype,
                              init=bias_initializer,
                              allow_deferred_init=True) if use_bias else None

    def infer_shape(self, x, *args):
        in_units = int(np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def forward(self, x):
        out = F.fully_connected(
            x, self.weight.data(),
            self.bias.data() if self.bias is not None else None,
            flatten=self._flatten)
        return self.act(out) if self.act is not None else out

    def extra_repr(self):
        return (f"{self.weight.shape[1] or None} -> {self._units}, "
                f"{self._activation}")


class Dropout(HybridBlock):
    """Inverted dropout, on only under `autograd.is_training`.  The mask
    is drawn from the ``generator`` attribute, a ``torch.Generator`` on
    the input's device (None, the default: `random.generator` of that
    device); a model gives every dropout of its tree one seeded generator
    (`models.layers.attach_generator`)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes
        self.generator = None

    def forward(self, x):
        gen = self.generator if self.generator is not None \
            else _rng.generator(x.device)
        return F.dropout(x, self._rate, generator=gen,
                         training=_ag.is_training(), axes=self._axes)

    def extra_repr(self):
        return f"p = {self._rate}, axes={self._axes}"


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True): row-sparse "
                             "gradients are not ported yet (ROADMAP.md A16)")
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = Parameter("weight", shape=(input_dim, output_dim),
                                dtype=dtype, init=weight_initializer)

    def forward(self, x):
        return F.embedding(x, self.weight.data())

    def extra_repr(self):
        return f"{self._input_dim} -> {self._output_dim}"


class BatchNorm(HybridBlock):
    """Batch normalisation over `axis` with MXNet's running statistics."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        shape = (in_channels,) if in_channels else (0,)
        defer = not in_channels
        self.gamma = Parameter("gamma", shape=shape, init=gamma_initializer,
                               allow_deferred_init=defer,
                               differentiable=scale)
        self.beta = Parameter("beta", shape=shape, init=beta_initializer,
                              allow_deferred_init=defer,
                              differentiable=center)
        self.running_mean = Parameter("running_mean", shape=shape,
                                      init=running_mean_initializer,
                                      allow_deferred_init=defer,
                                      grad_req="null", differentiable=False)
        self.running_var = Parameter("running_var", shape=shape,
                                     init=running_variance_initializer,
                                     allow_deferred_init=defer,
                                     grad_req="null", differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis % x.dim()]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def forward(self, x):
        return F.batch_norm(
            x, self.gamma.data(), self.beta.data(), self.running_mean.data(),
            self.running_var.data(), eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=_ag.is_training())

    def extra_repr(self):
        return f"axis={self._axis}, momentum={self._momentum}"


class BatchNormReLU(BatchNorm):
    def forward(self, x):
        return torch.relu(super().forward(x))


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm: waits for the port's multi-card work."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        raise MXNetError("SyncBatchNorm is not ported yet (ROADMAP.md A12: "
                         "multi-GPU parallel)")


class _Norm(HybridBlock):
    def __init__(self, center, scale, beta_initializer, gamma_initializer,
                 in_channels, **kwargs):
        super().__init__(**kwargs)
        shape = (in_channels,) if in_channels else (0,)
        defer = not in_channels
        self.gamma = Parameter("gamma", shape=shape, init=gamma_initializer,
                               allow_deferred_init=defer,
                               differentiable=scale)
        self.beta = Parameter("beta", shape=shape, init=beta_initializer,
                              allow_deferred_init=defer,
                              differentiable=center)


class LayerNorm(_Norm):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, **kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self._norm = F.layer_norm
        self._norm_residual = F.layer_norm_residual

    def infer_shape(self, x, *args):
        c = x.shape[self._axis % x.dim()]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def forward(self, x):
        axis = self._axis % x.dim()
        c = self.gamma.shape[0] if self.gamma.shape else 0
        if c and x.shape[axis] != c:
            raise MXNetError(
                f"LayerNorm: input axis {self._axis} has size "
                f"{x.shape[axis]}, expected {c}")
        if axis != x.dim() - 1:
            return F.layer_norm(x, self.gamma.data(), self.beta.data(),
                                axis=axis, eps=self._epsilon)
        return self._norm(x, self.gamma.data(), self.beta.data(),
                          eps=self._epsilon)

    def extra_repr(self):
        return f"axis={self._axis}, eps={self._epsilon}"


class RMSNorm(HybridBlock):
    """``y = x * rsqrt(mean(x^2) + eps) * gamma`` over the last axis."""

    def __init__(self, epsilon=1e-6, gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._epsilon = epsilon
        self._norm = F.rms_norm
        self.gamma = Parameter("gamma", shape=(in_channels,)
                               if in_channels else (0,),
                               init=gamma_initializer,
                               allow_deferred_init=not in_channels)

    def infer_shape(self, x, *args):
        self.gamma.shape = (x.shape[-1],)

    def forward(self, x):
        c = self.gamma.shape[0] if self.gamma.shape else 0
        if c and x.shape[-1] != c:
            raise MXNetError(f"RMSNorm: input last axis has size "
                             f"{x.shape[-1]}, expected {c}")
        return self._norm(x, self.gamma.data(), eps=self._epsilon)


class GroupNorm(_Norm):
    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, **kwargs)
        self._num_groups = num_groups
        self._epsilon = epsilon

    def infer_shape(self, x, *args):
        self.gamma.shape = (x.shape[1],)
        self.beta.shape = (x.shape[1],)

    def forward(self, x):
        return F.group_norm(x, self.gamma.data(), self.beta.data(),
                            num_groups=self._num_groups, eps=self._epsilon)


class InstanceNorm(_Norm):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, **kwargs)
        self._axis = axis
        self._epsilon = epsilon

    def infer_shape(self, x, *args):
        c = x.shape[self._axis % x.dim()]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def forward(self, x):
        return F.instance_norm(x, self.gamma.data(), self.beta.data(),
                               eps=self._epsilon)


class Flatten(HybridBlock):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


def _function(function):
    if isinstance(function, str):
        fn = getattr(F, function, None) or getattr(torch, function, None)
        if fn is None:
            raise MXNetError(f"unknown function {function}")
        return fn, function
    return function, getattr(function, "__name__", "lambda")


class Lambda(Block):
    """Wraps a function (or the name of an `ops.nn` / torch function)."""

    def __init__(self, function, **kwargs):
        super().__init__(**kwargs)
        self._func, self._fname = _function(function)

    def forward(self, *args):
        return self._func(*args)

    def extra_repr(self):
        return self._fname


class HybridLambda(HybridBlock):
    def __init__(self, function, **kwargs):
        super().__init__(**kwargs)
        self._func, self._fname = _function(function)

    def forward(self, *args):
        return self._func(*args)


class HybridConcatenate(HybridBlock):
    """Runs each child on the input and concatenates along `axis`."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def forward(self, x):
        return torch.cat([b(x) for b in self._child_blocks()],
                         dim=self.axis)


class Concatenate(HybridConcatenate):
    pass


class Identity(HybridBlock):
    def forward(self, x):
        return x
