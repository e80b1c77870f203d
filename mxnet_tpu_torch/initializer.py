"""Parameter initializers (counterpart of ``mxnet_tpu/initializer.py``;
parity with MXNet's ``python/mxnet/initializer.py``).

An initializer is called as ``init(name, tensor)`` and fills the tensor in
place.  The name picks the rule, as in MXNet: ``*gamma`` ones, ``*beta``
zeros, ``*running_mean`` / ``*moving_mean`` zeros, ``*running_var`` /
``*moving_var`` ones, ``*bias`` zeros, anything else the initializer's
weight rule.  The random rules draw in f32 from the tensor's device's
generator (`random.generator`, set by `random.seed`) and round to the
tensor's dtype.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from .base import MXNetError, Registry
from . import random as _rng

__all__ = [
    "Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
    "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias", "register",
    "create", "InitDesc", "Load", "Mixed", "RNNFused",
]

_registry = Registry("initializer")
register = _registry.register


def _fill(arr, value):
    """Write `value` (a tensor, numpy array or number) into `arr`."""
    with torch.no_grad():
        arr.copy_(torch.as_tensor(value).to(device=arr.device,
                                            dtype=arr.dtype))


def _uniform(arr, low, high):
    g = _rng.generator(arr.device)
    u = torch.rand(arr.shape, generator=g, device=arr.device)
    _fill(arr, low + (high - low) * u)


def _normal(arr, sigma):
    g = _rng.generator(arr.device)
    _fill(arr, torch.randn(arr.shape, generator=g, device=arr.device)
          * sigma)


class Initializer:
    """Base initializer; call as ``init(name, tensor)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        if self._kwargs.keys() != other._kwargs.keys():
            return False
        for k, v in self._kwargs.items():
            w = other._kwargs[k]
            try:
                if not bool(v == w):
                    return False
            except (TypeError, ValueError, RuntimeError):
                if not np.array_equal(np.asarray(_host(v)),
                                      np.asarray(_host(w))):
                    return False
        return True

    def __hash__(self):
        return hash((type(self), tuple(sorted(self._kwargs))))

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, name, arr=None):
        if arr is None:
            name, arr = "", name
        if name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(name, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        else:
            self._init_weight(name, arr)

    def init_array(self, arr):
        self._init_weight("", arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_bias(self, name, arr):
        _fill(arr, 0.0)

    def _init_gamma(self, name, arr):
        _fill(arr, 1.0)

    def _init_beta(self, name, arr):
        _fill(arr, 0.0)

    def _init_zero(self, name, arr):
        _fill(arr, 0.0)

    def _init_one(self, name, arr):
        _fill(arr, 1.0)


def _host(v):
    if torch.is_tensor(v):
        return v.detach().cpu().float().numpy()
    return v


@register(aliases=["zeros"])
class Zero(Initializer):
    def _init_weight(self, name, arr):
        _fill(arr, 0.0)


@register(aliases=["ones"])
class One(Initializer):
    def _init_weight(self, name, arr):
        _fill(arr, 1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        v = self.value
        _fill(arr, v if torch.is_tensor(v) else np.asarray(v))


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        _uniform(arr, -self.scale, self.scale)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _normal(arr, self.sigma)


@register
class Orthogonal(Initializer):
    """`scale` times an orthonormal basis from the SVD of a uniform or
    normal (out, prod(rest)) draw."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:])) if arr.dim() > 1 else 1
        g = _rng.generator(arr.device)
        if self.rand_type == "uniform":
            tmp = torch.rand((nout, nin), generator=g,
                             device=arr.device) * 2.0 - 1.0
        else:
            tmp = torch.randn((nout, nin), generator=g, device=arr.device)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        _fill(arr, (self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Glorot: U(-s, s) or N(0, s^2) with ``s = sqrt(magnitude /
    factor)``, `factor` the fan in, the fan out or their mean
    (``factor_type`` "in", "out", "avg"); dims past the second scale both
    fans."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale_of(self, shape) -> float:
        if len(shape) < 2:
            raise MXNetError(f"Xavier requires ndim>=2, got shape "
                             f"{tuple(shape)}")
        hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw, shape[0] * hw
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("invalid factor_type")
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, name, arr):
        scale = self.scale_of(arr.shape)
        if self.rnd_type == "uniform":
            _uniform(arr, -scale, scale)
        elif self.rnd_type == "gaussian":
            _normal(arr, scale)
        else:
            raise MXNetError("invalid rnd_type")


@register
class MSRAPrelu(Xavier):
    """He et al.: gaussian Xavier with magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two dims."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        n = int(np.prod(shape))
        weight = np.zeros(n, dtype=np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(n):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        _fill(arr, weight.reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter at `forget_bias`."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = np.zeros(arr.shape, dtype=np.float32)
        h = int(arr.shape[0] / 4)
        b[h:2 * h] = self.forget_bias
        _fill(arr, b)


def create(initializer, **kwargs):
    """An `Initializer` from an instance, a registered name or None
    (`Uniform`)."""
    if initializer is None:
        return Uniform()
    if isinstance(initializer, Initializer):
        return initializer
    if isinstance(initializer, str):
        return _registry.get(initializer)(**kwargs)
    raise MXNetError(f"cannot create initializer from {initializer!r}")


class InitDesc(str):
    """A parameter name carrying ``attrs`` and ``global_init``."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


@register
class Load(Initializer):
    """Values by parameter name from a dict (tensors or numpy arrays) or a
    `.npz` file (`util.load_arrays`); ``arg:`` / ``aux:`` prefixes are
    dropped; a name not found goes to `default_init` (an error when
    None)."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        if isinstance(param, str):
            from .util import load_arrays
            param = load_arrays(param)
        self.param = {(k[4:] if k.startswith(("arg:", "aux:")) else k): v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr=None):
        if arr is None:
            name, arr = "", name
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise MXNetError(
                    f"Load: parameter {name} has shape {tuple(arr.shape)} "
                    f"but the saved array is {tuple(src.shape)}")
            _fill(arr, src if torch.is_tensor(src) else np.asarray(src))
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise MXNetError(
                f"Load: no saved value for {name} and no default_init")


@register
class Mixed(Initializer):
    """The first initializer whose regex matches the name (``'.*'`` last
    as the fallback)."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must pair up")
        self.map = [(re.compile(p), i) for p, i in
                    zip(patterns, initializers)]

    def __call__(self, name, arr=None):
        if arr is None:
            name, arr = "", name
        for pat, init in self.map:
            if pat.match(name):
                init(name, arr)
                return
        raise MXNetError(
            f"Mixed: parameter {name} matched no pattern; add '.*' with a "
            f"default initializer as the last entry")


@register
class RNNFused(Initializer):
    """Fused-RNN packed weights: `init` for the weights, and the LSTM
    forget-gate quarter ([i, f, g, o]) of ``*i2h_bias`` at
    `forget_bias`."""

    def __init__(self, init="xavier", forget_bias=1.0):
        super().__init__()
        self._inner = create(init) if isinstance(init, str) else init
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        self._inner._init_weight(name, arr)

    def _init_bias(self, name, arr):
        vals = np.zeros(arr.shape, dtype=np.float32)
        n = arr.shape[0]
        if self.forget_bias and n % 4 == 0 and name.endswith("i2h_bias"):
            vals[n // 4:n // 2] = self.forget_bias
        _fill(arr, vals)
