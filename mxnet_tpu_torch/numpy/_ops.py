"""NumPy's functions on tensors: the torch bodies behind ``mx.np``.

Every function here takes tensors (and Python or NumPy values where NumPy
does) and returns tensors, with NumPy's semantics as the JAX package's
``jnp`` bodies give them with x64 off: ``axis`` / ``keepdims`` rather than
``dim`` / ``keepdim``, ``max`` / ``min`` returning values only, ``ddof=0``
variances, ``split`` by sections or indices, stable sorts, int32 indices
(`ndarray.wrap` narrows every int64 result).  ``mx.np`` wraps each with
`_wrap.wrap_fn`; `IMPLS` maps a NumPy name to its body.  A name of JAX's
``_DELEGATE`` table that is missing here raises by name (ROADMAP A16).
"""
from __future__ import annotations

import builtins
import math

import numpy as _onp
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..device import current_device, resolve_device
from ..ndarray.ndarray import to_torch_dtype

IMPLS = {}


def impl(*names):
    def reg(fn):
        for n in names:
            IMPLS[n] = fn
        return fn
    return reg


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def cur_device() -> torch.device:
    return resolve_device(current_device())


def host_tensor(x, device, dtype=None) -> torch.Tensor:
    """A host value (sequence, scalar, NumPy array) as a tensor on
    `device`: float64 becomes float32 and int64 int32, as ``jnp.asarray``
    does with x64 off; NumPy's bfloat16 (``ml_dtypes``) is read as its
    bits."""
    a = _onp.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(_onp.int16).copy()).view(torch.bfloat16)
    else:
        if a.dtype == _onp.float64:
            a = a.astype(_onp.float32)
        elif a.dtype == _onp.complex128:
            a = a.astype(_onp.complex64)
        elif a.dtype == _onp.int64:
            a = a.astype(_onp.int32)
        elif a.dtype == _onp.uint64:
            a = a.astype(_onp.uint32)
        elif a.dtype == object:
            raise MXNetError(f"cannot make an array of {type(x).__name__}")
        t = torch.from_numpy(_onp.array(a, order="C", copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _t(x, ref=None) -> torch.Tensor:
    """`x` as a tensor, on `ref`'s device when `ref` is a tensor."""
    if isinstance(x, torch.Tensor):
        return x
    dev = ref.device if isinstance(ref, torch.Tensor) else cur_device()
    return host_tensor(x, dev)


def _operand(x, ref) -> torch.Tensor:
    """An operand beside tensor `ref`: a Python scalar becomes a 0-d
    tensor, which takes part in promotion as NumPy's weak scalars do."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, _onp.generic):
        x = x.item()
    if isinstance(x, (builtins.bool, int, float, complex)):
        if isinstance(x, float):
            return torch.tensor(x, dtype=torch.float32, device=ref.device)
        return torch.tensor(x, device=ref.device)
    return _t(x, ref)


def _pair(a, b, promote=True):
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = _t(a)
    if isinstance(a, torch.Tensor):
        b = _operand(b, a)
    else:
        a = _operand(a, b)
    if promote and a.dtype != b.dtype:
        dt = torch.result_type(a, b)
        a, b = a.to(dt), b.to(dt)
    return a, b


def _float(x):
    """`x` in a float dtype (ints and bools in float32)."""
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float32)


def _axes(axis, nd):
    if axis is None:
        return tuple(range(nd))
    if isinstance(axis, (tuple, list)):
        return tuple(sorted(a % builtins.max(nd, 1) for a in axis))
    return (axis % builtins.max(nd, 1),)


def _lastdims(x, axis):
    """`x` with the axes `axis` (None: all) moved last and flattened into
    one, and the shape a kept-dims result takes."""
    nd = x.dim()
    axes = _axes(axis, nd) if nd else ()
    keep = [d for d in range(nd) if d not in axes]
    y = x.permute(*keep, *axes) if nd else x
    y = y.reshape(*[x.shape[d] for d in keep], -1)
    kshape = [1 if d in axes else x.shape[d] for d in range(nd)]
    return y, kshape


def _reduce(x, axis, keepdims, f):
    y, kshape = _lastdims(x, axis)
    r = f(y)
    return r.reshape(kshape) if keepdims else r


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

def _cbrt(x):
    x = _float(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _spacing(x):
    x = _float(x)
    inf = torch.full_like(x, math.inf)
    return torch.nextafter(x, torch.where(torch.signbit(x), -inf, inf)) - x


def _modf(x):
    x = _float(x)
    i = torch.trunc(x)
    return x - i, i


def _round(x, decimals=0):
    if not (x.is_floating_point() or x.is_complex()):
        return x.clone()
    return torch.round(x, decimals=decimals) if decimals else torch.round(x)


_UNARY = {
    "negative": torch.neg, "positive": torch.positive,
    "absolute": torch.abs, "abs": torch.abs,
    "fabs": lambda x: torch.abs(_float(x)), "sign": torch.sign,
    "rint": lambda x: torch.round(_float(x)),
    "conj": lambda x: torch.conj(x).resolve_conj(),
    "conjugate": lambda x: torch.conj(x).resolve_conj(),
    "exp": torch.exp, "expm1": torch.expm1, "exp2": torch.exp2,
    "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "sqrt": torch.sqrt, "cbrt": _cbrt,
    "square": torch.square, "reciprocal": torch.reciprocal,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "rad2deg": torch.rad2deg,
    "radians": torch.deg2rad, "deg2rad": torch.deg2rad,
    "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
    "fix": torch.fix, "i0": lambda x: torch.i0(_float(x)),
    "sinc": torch.sinc,
    "isfinite": torch.isfinite, "isinf": torch.isinf,
    "isnan": torch.isnan, "isneginf": torch.isneginf,
    "isposinf": torch.isposinf, "signbit": torch.signbit,
    "logical_not": torch.logical_not, "bitwise_not": torch.bitwise_not,
    "invert": torch.bitwise_not, "real": torch.real, "imag": _imag,
    "angle": torch.angle, "spacing": _spacing,
    "frexp": torch.frexp, "modf": _modf,
    "isreal": torch.isreal,
    "iscomplex": lambda x: _imag(x) != 0,
}
for _n, _f in _UNARY.items():
    IMPLS[_n] = (lambda f: lambda x: f(_t(x)))(_f)


@impl("round", "around", "round_")
def round_(a, decimals=0):
    return _round(_t(a), decimals)


@impl("nan_to_num")
def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    x = _t(x)
    if not x.is_floating_point():
        return x.clone()
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def _hypot(a, b):
    return torch.hypot(_float(a), _float(b))


def _atan2(a, b):
    return torch.atan2(_float(a), _float(b))


_BINARY = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.true_divide, "true_divide": torch.true_divide,
    "floor_divide": torch.floor_divide, "mod": torch.remainder,
    "remainder": torch.remainder, "fmod": torch.fmod, "power": torch.pow,
    "float_power": torch.float_power, "arctan2": _atan2, "hypot": _hypot,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "fmax": torch.fmax, "fmin": torch.fmin, "copysign": torch.copysign,
    "nextafter": torch.nextafter, "logaddexp": torch.logaddexp,
    "logaddexp2": torch.logaddexp2, "gcd": torch.gcd, "lcm": torch.lcm,
    "heaviside": torch.heaviside,
    "equal": torch.eq, "not_equal": torch.ne, "less": torch.lt,
    "less_equal": torch.le, "greater": torch.gt,
    "greater_equal": torch.ge, "logical_and": torch.logical_and,
    "logical_or": torch.logical_or, "logical_xor": torch.logical_xor,
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
}
for _n, _f in _BINARY.items():
    IMPLS[_n] = (lambda f: lambda x1, x2: f(*_pair(x1, x2)))(_f)


@impl("ldexp")
def ldexp(x1, x2):
    x1, x2 = _pair(x1, x2, promote=False)
    return torch.ldexp(_float(x1), x2)


@impl("divmod")
def divmod_(x1, x2):
    a, b = _pair(x1, x2)
    return torch.floor_divide(a, b), torch.remainder(a, b)


@impl("clip")
def clip(a, a_min=None, a_max=None):
    a = _t(a)
    if a_min is None and a_max is None:
        raise MXNetError("clip: one of a_min and a_max must be given")
    lo = None if a_min is None else _operand(a_min, a)
    hi = None if a_max is None else _operand(a_max, a)
    dt = a.dtype
    for b in (lo, hi):
        if b is not None:
            dt = torch.promote_types(dt, torch.result_type(a, b))
    a = a.to(dt)
    lo = None if lo is None else lo.to(dt)
    hi = None if hi is None else hi.to(dt)
    return torch.clamp(a, lo, hi)


@impl("isclose")
def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _pair(a, b)
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


@impl("allclose")
def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return isclose(a, b, rtol, atol, equal_nan).all()


@impl("array_equal")
def array_equal(a1, a2, equal_nan=False):
    a1, a2 = _t(a1), _t(a2, a1)
    if a1.shape != a2.shape:
        return torch.tensor(False, device=a1.device)
    a1, a2 = _pair(a1, a2)
    eq = a1 == a2
    if equal_nan and a1.is_floating_point():
        eq = eq | (torch.isnan(a1) & torch.isnan(a2))
    return eq.all()


@impl("array_equiv")
def array_equiv(a1, a2):
    a1, a2 = _pair(a1, a2)
    try:
        a1, a2 = torch.broadcast_tensors(a1, a2)
    except RuntimeError:
        return torch.tensor(False, device=a1.device)
    return (a1 == a2).all()


@impl("isrealobj")
def isrealobj(x):
    x = _t(x)
    return torch.tensor(not x.is_complex(), device=x.device)


@impl("iscomplexobj")
def iscomplexobj(x):
    return isinstance(x, torch.Tensor) and x.is_complex()


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _acc(x, dtype):
    """`x` in the dtype a sum accumulates in: `dtype`, else float32 for a
    16-bit float (cast back after), else `x`'s own."""
    if dtype is not None:
        return x.to(to_torch_dtype(dtype)), None
    if x.dtype in (torch.float16, torch.bfloat16):
        return x.to(torch.float32), x.dtype
    return x, None


@impl("sum")
def sum_(a, axis=None, dtype=None, keepdims=False, initial=None,
         where=None):
    a = _t(a)
    if where is not None:
        a = torch.where(_t(where, a), a, torch.zeros((), dtype=a.dtype,
                                                       device=a.device))
    x, back = _acc(a, dtype)
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    r = _reduce(x, axis, keepdims, lambda y: y.sum(-1))
    if initial is not None:
        r = r + initial
    return r if back is None else r.to(back)


@impl("mean")
def mean(a, axis=None, dtype=None, keepdims=False, where=None):
    a = _t(a)
    x, back = _acc(a, dtype)
    x = _float(x)
    if where is not None:
        w = _t(where, a).broadcast_to(x.shape)
        s = _reduce(torch.where(w, x, 0.0), axis, keepdims,
                    lambda y: y.sum(-1))
        n = _reduce(w.to(x.dtype), axis, keepdims, lambda y: y.sum(-1))
        r = s / n
    else:
        r = _reduce(x, axis, keepdims, lambda y: y.mean(-1))
    return r if back is None else r.to(back)


@impl("prod")
def prod(a, axis=None, dtype=None, keepdims=False, initial=None,
         where=None):
    a = _t(a)
    x, back = _acc(a, dtype)
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    r = _reduce(x, axis, keepdims, lambda y: y.prod(-1))
    if initial is not None:
        r = r * initial
    return r if back is None else r.to(back)


@impl("var")
def var(a, axis=None, dtype=None, ddof=0, keepdims=False):
    x = _float(_t(a))
    return _reduce(x, axis, keepdims, lambda y: y.var(-1, correction=ddof))


@impl("std")
def std(a, axis=None, dtype=None, ddof=0, keepdims=False):
    x = _float(_t(a))
    return _reduce(x, axis, keepdims, lambda y: y.std(-1, correction=ddof))


@impl("max", "amax")
def amax(a, axis=None, keepdims=False, initial=None, where=None):
    r = _reduce(_t(a), axis, keepdims, lambda y: y.amax(-1))
    return r if initial is None else torch.clamp(r, min=initial)


@impl("min", "amin")
def amin(a, axis=None, keepdims=False, initial=None, where=None):
    r = _reduce(_t(a), axis, keepdims, lambda y: y.amin(-1))
    return r if initial is None else torch.clamp(r, max=initial)


@impl("ptp")
def ptp(a, axis=None, keepdims=False):
    a = _t(a)
    return amax(a, axis, keepdims) - amin(a, axis, keepdims)


def _nan_fill(x, v):
    return torch.where(torch.isnan(x), torch.full_like(x, v), x) \
        if x.is_floating_point() else x


@impl("nansum")
def nansum(a, axis=None, dtype=None, keepdims=False):
    return sum_(_nan_fill(_t(a), 0.0), axis, dtype, keepdims)


@impl("nanprod")
def nanprod(a, axis=None, dtype=None, keepdims=False):
    return prod(_nan_fill(_t(a), 1.0), axis, dtype, keepdims)


@impl("nanmean")
def nanmean(a, axis=None, dtype=None, keepdims=False):
    a = _float(_t(a))
    ok = ~torch.isnan(a)
    return sum_(torch.where(ok, a, 0.0), axis, dtype, keepdims) / \
        sum_(ok.to(a.dtype), axis, None, keepdims)


@impl("nanvar")
def nanvar(a, axis=None, dtype=None, ddof=0, keepdims=False):
    a = _float(_t(a))
    ok = ~torch.isnan(a)
    n = sum_(ok.to(a.dtype), axis, None, True)
    m = sum_(torch.where(ok, a, 0.0), axis, None, True) / n
    d = torch.where(ok, a - m, 0.0)
    r = sum_(d * d, axis, None, True) / (n - ddof)
    return r if keepdims else _reduce(r, axis, False, lambda y: y[..., 0])


@impl("nanstd")
def nanstd(a, axis=None, dtype=None, ddof=0, keepdims=False):
    return torch.sqrt(nanvar(a, axis, dtype, ddof, keepdims))


@impl("nanmax")
def nanmax(a, axis=None, keepdims=False):
    a = _t(a)
    r = amax(_nan_fill(a, -math.inf), axis, keepdims)
    if a.is_floating_point():
        r = torch.where(_reduce(torch.isnan(a), axis, keepdims,
                                lambda y: y.all(-1)), math.nan, r)
    return r


@impl("nanmin")
def nanmin(a, axis=None, keepdims=False):
    a = _t(a)
    r = amin(_nan_fill(a, math.inf), axis, keepdims)
    if a.is_floating_point():
        r = torch.where(_reduce(torch.isnan(a), axis, keepdims,
                                lambda y: y.all(-1)), math.nan, r)
    return r


@impl("all")
def all_(a, axis=None, keepdims=False, where=None):
    return _reduce(_t(a).to(torch.bool), axis, keepdims, lambda y: y.all(-1))


@impl("any")
def any_(a, axis=None, keepdims=False, where=None):
    return _reduce(_t(a).to(torch.bool), axis, keepdims, lambda y: y.any(-1))


@impl("count_nonzero")
def count_nonzero(a, axis=None, keepdims=False):
    return _reduce((_t(a) != 0).to(torch.int32), axis, keepdims,
                   lambda y: y.sum(-1))


def _quantile(a, q, axis, keepdims, method, nan):
    a = _t(a)
    qt = _operand(q, a).to(torch.float32)
    x = a.to(torch.float32)
    y, kshape = _lastdims(x, axis)
    fn = torch.nanquantile if nan else torch.quantile
    r = fn(y, qt, dim=-1, interpolation=method)
    if keepdims:
        r = r.reshape(tuple(qt.shape) + tuple(kshape))
    back = a.dtype if a.is_floating_point() else torch.float32
    return r.to(back)


@impl("quantile")
def quantile(a, q, axis=None, out=None, overwrite_input=False,
             method="linear", keepdims=False):
    return _quantile(a, q, axis, keepdims, method, False)


@impl("nanquantile")
def nanquantile(a, q, axis=None, out=None, overwrite_input=False,
                method="linear", keepdims=False):
    return _quantile(a, q, axis, keepdims, method, True)


@impl("percentile")
def percentile(a, q, axis=None, out=None, overwrite_input=False,
               method="linear", keepdims=False):
    return _quantile(a, _operand(q, _t(a)) / 100.0, axis, keepdims, method,
                     False)


@impl("nanpercentile")
def nanpercentile(a, q, axis=None, out=None, overwrite_input=False,
                  method="linear", keepdims=False):
    return _quantile(a, _operand(q, _t(a)) / 100.0, axis, keepdims, method,
                     True)


@impl("median")
def median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    return _quantile(a, 0.5, axis, keepdims, "linear", False)


@impl("nanmedian")
def nanmedian(a, axis=None, out=None, overwrite_input=False,
              keepdims=False):
    return _quantile(a, 0.5, axis, keepdims, "linear", True)


@impl("average")
def average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _float(_t(a))
    if weights is None:
        r = mean(a, axis, keepdims=keepdims)
        n = torch.full_like(r, a.numel() / builtins.max(r.numel(), 1))
        return (r, n) if returned else r
    w = _t(weights, a).to(a.dtype)
    if w.shape != a.shape:
        if axis is None or w.dim() != 1:
            raise MXNetError("average: weights of another shape than a "
                             "need a 1-D weights and an int axis")
        shape = [1] * a.dim()
        shape[axis % a.dim()] = w.shape[0]
        w = w.reshape(shape)
    w = w.broadcast_to(a.shape)
    sw = sum_(w, axis, keepdims=keepdims)
    r = sum_(a * w, axis, keepdims=keepdims) / sw
    return (r, sw) if returned else r


def _argx(a, axis, keepdims, fn):
    a = _t(a)
    if axis is None:
        r = fn(a.reshape(-1), 0)
        return r.reshape([1] * a.dim()) if keepdims else r
    return fn(a, axis) if not keepdims else fn(a, axis).unsqueeze(axis)


@impl("argmax")
def argmax(a, axis=None, out=None, keepdims=False):
    return _argx(a, axis, keepdims, lambda x, d: torch.argmax(x, dim=d))


@impl("argmin")
def argmin(a, axis=None, out=None, keepdims=False):
    return _argx(a, axis, keepdims, lambda x, d: torch.argmin(x, dim=d))


@impl("nanargmax")
def nanargmax(a, axis=None, out=None, keepdims=False):
    return argmax(_nan_fill(_t(a), -math.inf), axis, None, keepdims)


@impl("nanargmin")
def nanargmin(a, axis=None, out=None, keepdims=False):
    return argmin(_nan_fill(_t(a), math.inf), axis, None, keepdims)


def _cum(a, axis, dtype, fn):
    a = _t(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    dt = to_torch_dtype(dtype)
    if dt is None and a.dtype == torch.bool:
        dt = torch.int32
    return fn(a, axis, dtype=dt)


@impl("cumsum")
def cumsum(a, axis=None, dtype=None):
    return _cum(a, axis, dtype, torch.cumsum)


@impl("cumprod")
def cumprod(a, axis=None, dtype=None):
    return _cum(a, axis, dtype, torch.cumprod)


@impl("nancumsum")
def nancumsum(a, axis=None, dtype=None):
    return cumsum(_nan_fill(_t(a), 0.0), axis, dtype)


@impl("nancumprod")
def nancumprod(a, axis=None, dtype=None):
    return cumprod(_nan_fill(_t(a), 1.0), axis, dtype)


def _edge(v, a, axis):
    v = _operand(v, a).to(a.dtype)
    if v.dim() == 0:
        shape = list(a.shape)
        shape[axis] = 1
        v = v.broadcast_to(shape)
    return v


@impl("diff")
def diff(a, n=1, axis=-1, prepend=None, append=None):
    a = _t(a)
    axis = axis % a.dim()
    pre = None if prepend is None else _edge(prepend, a, axis)
    app = None if append is None else _edge(append, a, axis)
    return torch.diff(a, n=n, dim=axis, prepend=pre, append=app)


@impl("ediff1d")
def ediff1d(ary, to_end=None, to_begin=None):
    a = _t(ary).reshape(-1)
    parts = [] if to_begin is None else [_t(to_begin, a).reshape(-1)
                                         .to(a.dtype)]
    parts.append(a[1:] - a[:-1])
    if to_end is not None:
        parts.append(_t(to_end, a).reshape(-1).to(a.dtype))
    return torch.cat(parts)


@impl("gradient")
def gradient(f, *varargs, axis=None, edge_order=1):
    f = _float(_t(f))
    dims = list(range(f.dim())) if axis is None else \
        [a % f.dim() for a in (axis if isinstance(axis, (tuple, list))
                                else (axis,))]
    kw = {"dim": dims, "edge_order": edge_order}
    if varargs:
        kw["spacing"] = [v.item() if isinstance(v, torch.Tensor)
                         and v.dim() == 0 else v for v in varargs] \
            if len(varargs) > 1 else (varargs[0].item() if isinstance(
                varargs[0], torch.Tensor) else varargs[0])
    out = torch.gradient(f, **kw)
    return out[0] if len(dims) == 1 else list(out)


@impl("trapezoid", "trapz")
def trapezoid(y, x=None, dx=1.0, axis=-1):
    y = _float(_t(y))
    if x is None:
        return torch.trapezoid(y, dx=dx, dim=axis)
    return torch.trapezoid(y, _float(_t(x, y)), dim=axis)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

@impl("dot")
def dot(a, b):
    a, b = _pair(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    if a.dim() >= 2 and b.dim() >= 2:
        return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))
    return torch.matmul(a, b)


@impl("vdot")
def vdot(a, b):
    a, b = _pair(a, b)
    return torch.dot(torch.conj(a).resolve_conj().reshape(-1),
                     b.reshape(-1))


@impl("inner")
def inner(a, b):
    a, b = _pair(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 1]))


@impl("outer")
def outer(a, b):
    a, b = _pair(a, b)
    return torch.outer(a.reshape(-1), b.reshape(-1))


@impl("tensordot")
def tensordot(a, b, axes=2):
    a, b = _pair(a, b)
    if isinstance(axes, (tuple, list)):
        axes = [list(x) if isinstance(x, (tuple, list)) else [x]
                for x in axes]
    return torch.tensordot(a, b, dims=axes)


@impl("kron")
def kron(a, b):
    return torch.kron(*_pair(a, b))


@impl("trace")
def trace(a, offset=0, axis1=0, axis2=1, dtype=None):
    d = torch.diagonal(_t(a), offset, axis1, axis2)
    return sum_(d, -1, dtype)


@impl("cross")
def cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    a, b = _pair(a, b)
    if axis is not None:
        axisa = axisb = axisc = axis
    a, b = a.movedim(axisa, -1), b.movedim(axisb, -1)
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1).movedim(-1, axisc)


@impl("matmul")
def matmul(a, b):
    return torch.matmul(*_pair(a, b))


@impl("einsum")
def einsum(subscripts, *operands, **kwargs):
    ops = [_t(o) for o in operands]
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(subscripts, *[o.to(dt) for o in ops])


def _conv_full(a, v):
    """The full 1-D convolution of `a` and `v` (len(a) >= len(v))."""
    x = _float(a)[None, None]
    w = _float(v).to(x.dtype).flip(0)[None, None]
    return F.conv1d(x, w, padding=v.shape[0] - 1)[0, 0]


@impl("convolve")
def convolve(a, v, mode="full"):
    a, v = _pair(a, v)
    a, v = a.reshape(-1), v.reshape(-1)
    if v.shape[0] > a.shape[0]:
        a, v = v, a
    full = _conv_full(a, v)
    m, n = a.shape[0], v.shape[0]
    if mode == "full":
        return full
    if mode == "same":
        s = (n - 1) // 2
        return full[s:s + m]
    if mode == "valid":
        return full[n - 1:m]
    raise MXNetError(f"convolve: unknown mode {mode!r}")


@impl("correlate")
def correlate(a, v, mode="valid"):
    a, v = _pair(a, v)
    return convolve(a, torch.conj(v.reshape(-1)).resolve_conj().flip(0),
                    mode)


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

@impl("reshape")
def reshape(a, newshape=None, order="C", shape=None):
    if order != "C":
        raise MXNetError("reshape: only order='C' is supported")
    newshape = shape if newshape is None else newshape
    if isinstance(newshape, int):
        newshape = (newshape,)
    return _t(a).reshape(tuple(newshape))


@impl("ravel")
def ravel(a, order="C"):
    return _t(a).reshape(-1)


@impl("transpose", "permute_dims")
def transpose(a, axes=None):
    a = _t(a)
    if axes is None:
        axes = tuple(reversed(range(a.dim())))
    return a.permute(*axes)


@impl("swapaxes")
def swapaxes(a, axis1, axis2):
    return _t(a).transpose(axis1, axis2)


@impl("moveaxis")
def moveaxis(a, source, destination):
    return torch.movedim(_t(a), source, destination)


@impl("rollaxis")
def rollaxis(a, axis, start=0):
    a = _t(a)
    nd = a.dim()
    axis %= nd
    if start < 0:
        start += nd
    if axis < start:
        start -= 1
    if axis == start:
        return a
    order = [d for d in range(nd) if d != axis]
    order.insert(start, axis)
    return a.permute(*order)


@impl("expand_dims")
def expand_dims(a, axis):
    a = _t(a)
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    nd = a.dim() + len(axes)
    for ax in sorted(x % nd for x in axes):
        a = a.unsqueeze(ax)
    return a


@impl("squeeze")
def squeeze(a, axis=None):
    a = _t(a)
    if axis is None:
        return a.squeeze()
    axes = _axes(axis, a.dim())
    for ax in axes:
        if a.shape[ax] != 1:
            raise MXNetError(f"squeeze: axis {ax} of shape {tuple(a.shape)}"
                             " is not 1")
    shape = [n for d, n in enumerate(a.shape) if d not in axes]
    return a.reshape(shape)


@impl("broadcast_to")
def broadcast_to(array, shape):
    a = _t(array)
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(shape)
    if -2 in shape:
        off = len(shape) - a.dim()
        res = []
        for i, d in enumerate(shape):
            if d == -2:
                if i - off < 0:
                    raise MXNetError(
                        "broadcast_to: the objective shape for "
                        "broadcasting array must be known; -2 at dim "
                        f"{i} has no corresponding input dim")
                res.append(a.shape[i - off])
            else:
                res.append(d)
        shape = tuple(res)
    return a.broadcast_to(shape)


@impl("broadcast_arrays")
def broadcast_arrays(*args):
    ts = [_t(a) for a in args]
    return list(torch.broadcast_tensors(*ts))


def _atleast(fn):
    def f(*arys):
        out = [fn(_t(a)) for a in arys]
        return out[0] if len(out) == 1 else out
    return f


IMPLS["atleast_1d"] = _atleast(torch.atleast_1d)
IMPLS["atleast_2d"] = _atleast(torch.atleast_2d)
IMPLS["atleast_3d"] = _atleast(torch.atleast_3d)


@impl("flip")
def flip(m, axis=None):
    m = _t(m)
    return torch.flip(m, _axes(axis, m.dim()))


@impl("fliplr")
def fliplr(m):
    return torch.flip(_t(m), (1,))


@impl("flipud")
def flipud(m):
    return torch.flip(_t(m), (0,))


@impl("rot90")
def rot90(m, k=1, axes=(0, 1)):
    return torch.rot90(_t(m), k, list(axes))


@impl("roll")
def roll(a, shift, axis=None):
    a = _t(a)
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


@impl("repeat")
def repeat(a, repeats, axis=None):
    a = _t(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.long()
    return torch.repeat_interleave(a, repeats, dim=axis)


@impl("tile")
def tile(a, reps):
    if isinstance(reps, int):
        reps = (reps,)
    return torch.tile(_t(a), tuple(reps))


@impl("append")
def append(arr, values, axis=None):
    a = _t(arr)
    v = _t(values, a)
    dt = torch.promote_types(a.dtype, v.dtype)
    if axis is None:
        return torch.cat([a.reshape(-1).to(dt), v.reshape(-1).to(dt)])
    return torch.cat([a.to(dt), v.to(dt)], dim=axis)


@impl("trim_zeros")
def trim_zeros(filt, trim="fb"):
    f = _t(filt)
    nz = torch.nonzero(f).reshape(-1).tolist()
    if not nz:
        return f[:0]
    lo = nz[0] if "f" in trim.lower() else 0
    hi = nz[-1] + 1 if "b" in trim.lower() else f.shape[0]
    return f[lo:hi]


@impl("tril")
def tril(m, k=0):
    return torch.tril(_t(m), k)


@impl("triu")
def triu(m, k=0):
    return torch.triu(_t(m), k)


@impl("diag")
def diag(v, k=0):
    return torch.diag(_t(v), k)


@impl("diagflat")
def diagflat(v, k=0):
    return torch.diagflat(_t(v), k)


@impl("diagonal")
def diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_t(a), offset, axis1, axis2)


@impl("extract")
def extract(condition, arr):
    a = _t(arr)
    return a.reshape(-1)[_t(condition, a).reshape(-1).to(torch.bool)]


# ---------------------------------------------------------------------------
# indexing and selection
# ---------------------------------------------------------------------------

def _index(idx, n, mode):
    idx = idx.long()
    if mode == "clip":
        return idx.clamp(0, n - 1)
    if mode == "wrap":
        return idx.remainder(n)
    return torch.where(idx < 0, idx + n, idx)


@impl("take")
def take(a, indices, axis=None, out=None, mode=None):
    a = _t(a)
    idx = _t(indices, a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis %= a.dim()
    i = _index(idx, a.shape[axis], mode)
    r = torch.index_select(a, axis, i.reshape(-1))
    return r.reshape(tuple(a.shape[:axis]) + tuple(idx.shape) +
                     tuple(a.shape[axis + 1:]))


@impl("take_along_axis")
def take_along_axis(arr, indices, axis):
    a = _t(arr)
    i = _t(indices, a).long()
    if axis is None:
        return torch.take_along_dim(a.reshape(-1), i.reshape(-1))
    return torch.take_along_dim(a, i, dim=axis)


@impl("choose")
def choose(a, choices, out=None, mode="raise"):
    a = _t(a)
    ts = torch.broadcast_tensors(a, *[_t(c, a) for c in choices])
    idx = _index(ts[0], len(choices), mode)
    return torch.gather(torch.stack(ts[1:]), 0, idx[None])[0]


@impl("compress")
def compress(condition, a, axis=None):
    a = _t(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    c = _t(condition, a).reshape(-1).to(torch.bool)
    keep = torch.nonzero(c).reshape(-1)
    return torch.index_select(a, axis, keep)


@impl("searchsorted")
def searchsorted(a, v, side="left", sorter=None):
    a = _t(a)
    if sorter is not None:
        a = a[_t(sorter, a).long()]
    vt = _operand(v, a).to(a.dtype)
    return torch.searchsorted(a, vt, right=side == "right")


@impl("digitize")
def digitize(x, bins, right=False):
    x = _t(x)
    b = _t(bins, x).to(x.dtype)
    return torch.bucketize(x, b, right=not right)


@impl("select")
def select(condlist, choicelist, default=0):
    conds = [_t(c) for c in condlist]
    ch = [_t(c, conds[0]) for c in choicelist]
    dt = ch[0].dtype
    for c in ch[1:]:
        dt = torch.promote_types(dt, c.dtype)
    out = _operand(default, ch[0]).to(dt)
    for c, v in reversed(list(zip(conds, ch))):
        out = torch.where(c, v.to(dt), out)
    return out


@impl("indices")
def indices(dimensions, dtype=None, sparse=False):
    dev = cur_device()
    dt = to_torch_dtype(dtype) or torch.int32
    grids = torch.meshgrid(*[torch.arange(n, device=dev) for n in
                             dimensions], indexing="ij")
    return torch.stack(grids).to(dt)


@impl("unravel_index")
def unravel_index(indices, shape, order="C"):
    idx = _t(indices).long()
    out = []
    for n in reversed(tuple(shape)):
        out.append(idx % n)
        idx = idx // n
    return tuple(reversed(out))


@impl("ravel_multi_index")
def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    idx = [_t(i).long() for i in multi_index]
    out = torch.zeros_like(idx[0])
    for i, n in zip(idx, dims):
        out = out * n + i
    return out


@impl("tril_indices")
def tril_indices(n, k=0, m=None):
    r = torch.tril_indices(n, n if m is None else m, k,
                           device=cur_device())
    return r[0], r[1]


@impl("triu_indices")
def triu_indices(n, k=0, m=None):
    r = torch.triu_indices(n, n if m is None else m, k,
                           device=cur_device())
    return r[0], r[1]


@impl("tril_indices_from")
def tril_indices_from(arr, k=0):
    a = _t(arr)
    r = torch.tril_indices(a.shape[-2], a.shape[-1], k, device=a.device)
    return r[0], r[1]


@impl("diag_indices")
def diag_indices(n, ndim=2):
    i = torch.arange(n, device=cur_device())
    return tuple(i for _ in range(ndim))


# ---------------------------------------------------------------------------
# sorting and sets
# ---------------------------------------------------------------------------

@impl("sort")
def sort(a, axis=-1, kind=None, order=None):
    a = _t(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.sort(a, dim=axis, stable=True).values


@impl("argsort")
def argsort(a, axis=-1, kind=None, order=None):
    a = _t(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.sort(a, dim=axis, stable=True).indices


@impl("lexsort")
def lexsort(keys, axis=-1):
    ks = [_t(k) for k in keys]
    idx = torch.sort(ks[0], stable=True).indices
    for k in ks[1:]:
        idx = idx[torch.sort(k[idx], stable=True).indices]
    return idx


def _unique(x):
    return torch.unique(_t(x).reshape(-1), sorted=True)


@impl("isin")
def isin(element, test_elements, assume_unique=False, invert=False):
    e = _t(element)
    r = torch.isin(e, _t(test_elements, e).to(e.dtype))
    return ~r if invert else r


@impl("in1d")
def in1d(ar1, ar2, assume_unique=False, invert=False):
    return isin(_t(ar1).reshape(-1), ar2, invert=invert)


@impl("setdiff1d")
def setdiff1d(ar1, ar2, assume_unique=False):
    u = _unique(ar1)
    return u[~torch.isin(u, _t(ar2, u).to(u.dtype))]


@impl("union1d")
def union1d(ar1, ar2):
    a = _t(ar1)
    b = _t(ar2, a)
    dt = torch.promote_types(a.dtype, b.dtype)
    return _unique(torch.cat([a.reshape(-1).to(dt), b.reshape(-1).to(dt)]))


@impl("intersect1d")
def intersect1d(ar1, ar2, assume_unique=False, return_indices=False):
    if return_indices:
        raise MXNetError("intersect1d(return_indices=True) is not ported "
                         "(ROADMAP A16)")
    u = _unique(ar1)
    return u[torch.isin(u, _t(ar2, u).to(u.dtype))]


@impl("setxor1d")
def setxor1d(ar1, ar2, assume_unique=False):
    a, b = _unique(ar1), _unique(ar2)
    b = b.to(a.device, a.dtype)
    return torch.sort(torch.cat([a[~torch.isin(a, b)],
                                 b[~torch.isin(b, a)]])).values


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

@impl("bincount")
def bincount(x, weights=None, minlength=0):
    x = _t(x).long()
    w = None if weights is None else _t(weights, x)
    return torch.bincount(x, w, minlength=minlength)


def _edges(a, bins, range_):
    if isinstance(bins, (torch.Tensor, list, tuple, _onp.ndarray)):
        return _t(bins, a).to(torch.float32)
    if range_ is None:
        lo, hi = float(a.min()), float(a.max())
    else:
        lo, hi = float(range_[0]), float(range_[1])
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return torch.linspace(lo, hi, int(bins) + 1, device=a.device)


@impl("histogram_bin_edges")
def histogram_bin_edges(a, bins=10, range=None, weights=None):
    return _edges(_float(_t(a)).reshape(-1), bins, range)


@impl("histogram")
def histogram(a, bins=10, range=None, weights=None, density=None):
    a = _float(_t(a)).reshape(-1)
    edges = _edges(a, bins, range)
    n = edges.shape[0] - 1
    i = torch.searchsorted(edges, a.to(edges.dtype), right=True) - 1
    i = torch.where(a.to(edges.dtype) == edges[-1], n - 1, i)
    ok = (i >= 0) & (i < n)
    w = torch.ones_like(a) if weights is None else \
        _t(weights, a).reshape(-1).to(a.dtype)
    hist = torch.zeros(n, dtype=w.dtype, device=a.device).index_add_(
        0, i[ok], w[ok])
    if density:
        hist = hist / (hist.sum() * (edges[1:] - edges[:-1]))
    return hist, edges


@impl("corrcoef")
def corrcoef(x, y=None, rowvar=True):
    x = _float(_t(x))
    x = x if x.dim() > 1 else x[None]
    if y is not None:
        yt = _float(_t(y, x))
        x = torch.cat([x, yt if yt.dim() > 1 else yt[None]])
    if not rowvar:
        x = x.T
    return torch.corrcoef(x)


@impl("cov")
def cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
        aweights=None):
    x = _float(_t(m))
    x = x if x.dim() > 1 else x[None]
    if not rowvar:
        x = x.T
    if y is not None:
        yt = _float(_t(y, x))
        yt = yt if yt.dim() > 1 else yt[None]
        x = torch.cat([x, yt if rowvar else yt.T])
    corr = ddof if ddof is not None else (0 if bias else 1)
    fw = None if fweights is None else _t(fweights, x).long()
    aw = None if aweights is None else _t(aweights, x)
    return torch.cov(x, correction=corr, fweights=fw, aweights=aw)


# ---------------------------------------------------------------------------
# the rest
# ---------------------------------------------------------------------------

@impl("interp")
def interp(x, xp, fp, left=None, right=None, period=None):
    if period is not None:
        raise MXNetError("interp(period=) is not ported (ROADMAP A16)")
    x = _float(_t(x))
    xp = _t(xp, x).to(x.dtype)
    fp = _t(fp, x).to(x.dtype)
    n = xp.shape[0]
    i = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    y = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    y = torch.where(x < xp[0], fp[0] if left is None else left, y)
    y = torch.where(x > xp[-1], fp[-1] if right is None else right, y)
    return y


@impl("pad")
def pad(array, pad_width, mode="constant", **kwargs):
    a = _t(array)
    nd = a.dim()
    pw = _onp.asarray(pad_width, dtype=_onp.int64)
    if pw.ndim == 0:
        pw = _onp.full((nd, 2), int(pw))
    elif pw.ndim == 1:
        pw = _onp.broadcast_to(pw.reshape(1, -1) if pw.size == 2 else
                               pw.reshape(-1, 1), (nd, 2))
    else:
        pw = _onp.broadcast_to(pw, (nd, 2))
    if mode == "constant":
        v = kwargs.get("constant_values", 0)
        flat = []
        for b, e in reversed(pw.tolist()):
            flat += [int(b), int(e)]
        return F.pad(a, flat, value=float(v) if a.is_floating_point()
                     else v)
    if mode not in ("edge", "reflect", "symmetric", "wrap"):
        raise MXNetError(f"pad mode {mode!r} is not ported (ROADMAP A16)")
    for ax, (b, e) in enumerate(pw.tolist()):
        if not b and not e:
            continue
        n = a.shape[ax]
        i = torch.arange(-b, n + e, device=a.device)
        if mode == "edge":
            i = i.clamp(0, n - 1)
        elif mode == "wrap":
            i = i.remainder(n)
        elif mode == "reflect":
            if n == 1:
                i = torch.zeros_like(i)
            else:
                i = i.remainder(2 * n - 2)
                i = torch.where(i >= n, 2 * n - 2 - i, i)
        else:
            i = i.remainder(2 * n)
            i = torch.where(i >= n, 2 * n - 1 - i, i)
        a = torch.index_select(a, ax, i)
    return a


@impl("flatnonzero")
def flatnonzero(a):
    return torch.nonzero(_t(a).reshape(-1)).reshape(-1)


@impl("vander")
def vander(x, N=None, increasing=False):
    return torch.vander(_t(x), N, increasing)


@impl("delete")
def delete(arr, obj, axis=None):
    a = _t(arr)
    if axis is None:
        a, axis = a.reshape(-1), 0
    n = a.shape[axis]
    keep = _onp.ones(n, bool)
    o = obj.cpu().numpy() if isinstance(obj, torch.Tensor) else obj
    keep[o] = False
    return torch.index_select(a, axis, torch.as_tensor(
        _onp.nonzero(keep)[0], device=a.device))


@impl("resize")
def resize(a, new_shape):
    a = _t(a)
    if isinstance(new_shape, int):
        new_shape = (new_shape,)
    n = int(_onp.prod(new_shape))
    flat = a.reshape(-1)
    if flat.numel() == 0:
        return torch.zeros(tuple(new_shape), dtype=a.dtype, device=a.device)
    reps = -(-n // flat.numel())
    return flat.repeat(reps)[:n].reshape(tuple(new_shape))


@impl("ix_")
def ix_(*args):
    ts = [_t(a) for a in args]
    k = len(ts)
    return tuple(t.reshape([-1 if i == j else 1 for j in range(k)])
                 for i, t in enumerate(ts))


@impl("polyval")
def polyval(p, x):
    p = _t(p)
    x = _t(x, p)
    dt = torch.promote_types(p.dtype, x.dtype)
    out = torch.zeros_like(x, dtype=dt)
    for c in p.to(dt):
        out = out * x + c
    return out


@impl("unwrap")
def unwrap(p, discont=None, axis=-1, period=2 * math.pi):
    p = _float(_t(p))
    axis %= p.dim()
    dd = torch.diff(p, dim=axis)
    half = period / 2
    discont = half if discont is None else builtins.max(discont, half)
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0), half, ddmod)
    corr = torch.where(dd.abs() < discont, 0.0, ddmod - dd)
    first = p.narrow(axis, 0, 1)
    rest = p.narrow(axis, 1, p.shape[axis] - 1) + torch.cumsum(corr, axis)
    return torch.cat([first, rest], dim=axis)


@impl("shape")
def shape(a):
    return tuple(a.shape) if hasattr(a, "shape") else _onp.shape(a)


@impl("ndim")
def ndim(a):
    return a.dim() if isinstance(a, torch.Tensor) else _onp.ndim(a)


@impl("size")
def size(a, axis=None):
    if axis is not None:
        return shape(a)[axis]
    return a.numel() if isinstance(a, torch.Tensor) else _onp.size(a)
