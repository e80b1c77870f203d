"""`mx.np` — MXNet's NumPy-compatible array namespace, over torch
(counterpart of ``mxnet_tpu/numpy/__init__.py``).

Arrays are `ndarray`s over tensors; creation goes to the current device
(the card unless ``with mx.cpu():``).  Every name of the JAX package's
``_DELEGATE`` table is here: the ported ones run a torch body of
`_ops` with NumPy's semantics (JAX's with x64 off, see `ndarray`), and the
rest raise `MXNetError` naming ROADMAP.md A16 (`UNPORTED`) — none falls
back to NumPy on the host.  Data-dependent shapes (`unique`, `nonzero`,
boolean masks) synchronise with the device, as the reference's shape
read-back does.  ``linalg`` and ``fft`` wait for A16.
"""
from __future__ import annotations

import builtins

import numpy as _onp
import torch

from ..base import MXNetError, UnportedModule, check_x64_dtype, unported
from ..device import current_device, resolve_device
from ..ndarray.ndarray import (_NARROW, _write_out, apply, bfloat16,
                               ndarray, to_np_dtype, to_torch_dtype, wrap)
from . import _ops
from ._ops import IMPLS, host_tensor
from ._wrap import wrap_fn

# -----------------------------------------------------------------------
# constants and dtypes
# -----------------------------------------------------------------------
pi = _onp.pi
e = _onp.e
euler_gamma = _onp.euler_gamma
inf = _onp.inf
nan = _onp.nan
newaxis = None
NINF = -_onp.inf
PZERO, NZERO = 0.0, -0.0

float16 = _onp.float16
float32 = _onp.float32
float64 = _onp.float64
int8 = _onp.int8
int16 = _onp.int16
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
uint16 = _onp.uint16
uint32 = _onp.uint32
uint64 = _onp.uint64
bool_ = _onp.bool_
bool = bool_  # noqa: A001 — MXNet exposes ``np.bool``
complex64 = _onp.complex64
complex128 = _onp.complex128
intp = _onp.intp

integer_dtypes = [int8, int16, int32, int64, uint8, uint16, uint32, uint64]
floating_dtypes = [float16, float32, float64]
numeric_dtypes = [*integer_dtypes, *floating_dtypes]
boolean_dtypes = [bool_]

_default_float = [float32]


def set_default_dtype(dtype):
    _default_float[0] = dtype


def default_dtype():
    return _default_float[0]


def _default_tdt():
    return to_torch_dtype(_default_float[0])


def finfo(dtype):
    if dtype == bfloat16:
        return torch.finfo(torch.bfloat16)
    return _onp.finfo(dtype)


def iinfo(dtype):
    return _onp.iinfo(dtype)


# -----------------------------------------------------------------------
# creation
# -----------------------------------------------------------------------

def _dev(device, ctx) -> torch.device:
    d = device if device is not None else ctx
    return resolve_device(current_device() if d is None else d)


def array(object, dtype=None, device=None, ctx=None, copy=True):
    """An array of `object` on `device` (the current device by default):
    a float64 host value becomes the default float, an int64 one int32; a
    tensor or an array is copied (``copy=False``: only where the device or
    dtype asks)."""
    dt = to_torch_dtype(dtype)
    if isinstance(object, ndarray):
        object = object._data
    if isinstance(object, torch.Tensor):
        t = object.detach() if copy else object
        want = dt or _NARROW.get(t.dtype, t.dtype)
        return wrap(t.to(_dev(device, ctx), want, copy=copy))
    dev = _dev(device, ctx)
    if dt is not None and dt is not torch.bfloat16:
        # through NumPy with the dtype: an out-of-range Python int raises
        # (OverflowError) instead of wrapping in a later cast
        npv = _onp.asarray(object, dtype=str(to_np_dtype(dt)))
        return wrap(host_tensor(npv, dev, dt))
    npv = _onp.asarray(object)
    if dt is None and npv.dtype == _onp.float64:
        dt = _default_tdt()
    return wrap(host_tensor(npv, dev, dt))


def asarray(a, dtype=None, device=None, ctx=None):
    """`a` as an array: an array comes back as it is, and a tensor is
    wrapped with no copy (the array shares its storage and its graph)
    unless a dtype or device asks for one."""
    if dtype is None and device is None and ctx is None:
        if isinstance(a, ndarray):
            return a
        if isinstance(a, torch.Tensor):
            return wrap(a)
    return array(a, dtype=dtype, device=device, ctx=ctx, copy=False)


def _creation(tfn):
    def fn(shape, dtype=None, order="C", device=None, ctx=None, **kw):
        dt = to_torch_dtype(dtype) or _default_tdt()
        if isinstance(shape, ndarray):
            shape = tuple(int(s) for s in shape.asnumpy())
        if isinstance(shape, int):
            shape = (shape,)
        return wrap(tfn(tuple(shape), dtype=dt, device=_dev(device, ctx)))
    fn.__name__ = tfn.__name__
    return fn


zeros = _creation(torch.zeros)
ones = _creation(torch.ones)
empty = _creation(torch.zeros)   # JAX's is zeros too


def _fill_dtype(fill_value):
    if isinstance(fill_value, ndarray):
        return fill_value._data.dtype
    if isinstance(fill_value, builtins.bool):
        return torch.bool
    if isinstance(fill_value, int):
        return torch.int32
    if isinstance(fill_value, _onp.generic):
        return to_torch_dtype(fill_value.dtype) \
            if fill_value.dtype != _onp.float64 else _default_tdt()
    return _default_tdt()


def full(shape, fill_value, dtype=None, order="C", device=None, ctx=None,
         out=None):
    dt = to_torch_dtype(dtype) or _fill_dtype(fill_value)
    if isinstance(shape, int):
        shape = (shape,)
    dev = _dev(device, ctx)
    if isinstance(fill_value, ndarray):
        t = fill_value._data.to(dev, dt).broadcast_to(tuple(shape)).clone()
    else:
        v = fill_value.item() if isinstance(fill_value, _onp.generic) \
            else fill_value
        t = torch.full(tuple(shape), v, dtype=dt, device=dev)
    return _write_out(wrap(t), out)


def _like(tfn, name):
    def fn(a, dtype=None, order="C", device=None, ctx=None):
        dt = to_torch_dtype(dtype)
        return apply(lambda t: tfn(t, dtype=dt), a)
    fn.__name__ = name
    return fn


zeros_like = _like(torch.zeros_like, "zeros_like")
ones_like = _like(torch.ones_like, "ones_like")
empty_like = zeros_like


def full_like(a, fill_value, dtype=None, order="C", device=None, ctx=None):
    dt = to_torch_dtype(dtype)
    fv = fill_value.item() if isinstance(fill_value, (ndarray,
                                                      _onp.generic)) \
        else fill_value
    return apply(lambda t: torch.full_like(t, fv, dtype=dt), a)


def arange(start, stop=None, step=1, dtype=None, device=None, ctx=None):
    """NumPy's arange, float32 by default for any input (MXNet's rule:
    an int result would cut gradients downstream)."""
    dt = to_torch_dtype(dtype) or _default_tdt()
    if stop is None:
        start, stop = 0, start
    return wrap(torch.arange(start, stop, step, dtype=dt,
                             device=_dev(device, ctx)))


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, device=None, ctx=None):
    dt = to_torch_dtype(dtype) or _default_tdt()
    dev = _dev(device, ctx)
    n = num if endpoint else num + 1
    t = torch.linspace(float(start), float(stop), n, dtype=torch.float32,
                       device=dev)
    if not endpoint:
        t = t[:-1]
    out = wrap(t.to(dt))
    if retstep:
        step = (float(stop) - float(start)) / builtins.max(
            (num - 1) if endpoint else num, 1)
        return out, step
    return out


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, device=None, ctx=None):
    dt = to_torch_dtype(dtype) or _default_tdt()
    lin = linspace(start, stop, num, endpoint, device=device, ctx=ctx)
    return wrap(torch.pow(torch.tensor(base, dtype=torch.float32,
                                       device=lin._data.device),
                          lin._data).to(dt))


def eye(N, M=None, k=0, dtype=None, device=None, ctx=None):
    dt = to_torch_dtype(dtype) or _default_tdt()
    M = N if M is None else M
    if not isinstance(N, int) or not isinstance(M, int) or N < 0 or M < 0:
        raise MXNetError(f"eye: N and M must be non-negative ints, got "
                         f"{N!r}, {M!r}")
    dev = _dev(device, ctx)
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(M, device=dev)[None, :]
    return wrap((j - i == k).to(dt))


def identity(n, dtype=None, device=None, ctx=None):
    return eye(n, dtype=dtype, device=device, ctx=ctx)


def tri(N, M=None, k=0, dtype=None, device=None, ctx=None):
    dt = to_torch_dtype(dtype) or _default_tdt()
    M = N if M is None else M
    dev = _dev(device, ctx)
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(M, device=dev)[None, :]
    return wrap((j - i <= k).to(dt))


def copy(a):
    return asarray(a).copy()


def meshgrid(*xi, **kwargs):
    indexing = kwargs.get("indexing", "xy")
    return apply(lambda *ts: list(torch.meshgrid(
        *[_ops._t(t) for t in ts], indexing=indexing)), *xi)


def fromfunction(function, shape, dtype=None, **kwargs):
    check_x64_dtype(dtype)
    return array(_onp.fromfunction(function, shape, dtype=dtype or
                                   _default_float[0], **kwargs))


# -----------------------------------------------------------------------
# data-dependent shapes (torch reads the sizes back from the card, as
# MXNet's shape read-back does)
# -----------------------------------------------------------------------

def _unique(t, return_index, return_inverse, return_counts, axis):
    t = _ops._t(t)
    u, inv, cnt = torch.unique(t, sorted=True, return_inverse=True,
                               return_counts=True, dim=axis)
    out = [u]
    if return_index:
        # each value's first position: the least position mapped to it
        n = t.numel() if axis is None else t.shape[axis]
        first = torch.full((cnt.numel(),), n, dtype=torch.int64,
                           device=t.device)
        first.scatter_reduce_(0, inv.reshape(-1),
                              torch.arange(n, device=t.device), "amin")
        out.append(first)
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(cnt)
    return out[0] if len(out) == 1 else tuple(out)


def unique(ar, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    return apply(_unique, ar, return_index, return_inverse, return_counts,
                 axis)


def nonzero(a):
    return apply(lambda t: torch.nonzero(_ops._t(t), as_tuple=True), a)


def argwhere(a):
    return apply(lambda t: torch.argwhere(_ops._t(t)), a)


def _where3(c, x, y):
    c = _ops._t(c)
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x = _ops._operand(x, c)
    x, y = _ops._pair(x, y)
    return torch.where(c.to(torch.bool), x, y)


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    return apply(_where3, condition, x, y)


# -----------------------------------------------------------------------
# joining and splitting
# -----------------------------------------------------------------------

def _seq(seq):
    ts = list(seq)
    ref = next((t for t in ts if isinstance(t, torch.Tensor)), None)
    ts = [_ops._t(t, ref) for t in ts]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _concatenate(seq, axis=0, dtype=None):
    ts = _seq(seq)
    if axis is None:
        ts, axis = [t.reshape(-1) for t in ts], 0
    r = torch.cat(ts, dim=axis)
    return r if dtype is None else r.to(to_torch_dtype(dtype))


def concatenate(seq, axis=0, out=None, dtype=None, casting="same_kind"):
    return _write_out(apply(_concatenate, list(seq), axis, dtype), out)


def stack(arrays, axis=0, out=None):
    return _write_out(apply(lambda s: torch.stack(_seq(s), dim=axis),
                            list(arrays)), out)


def _joiner(tfn, name):
    def fn(tup, out=None, **kwargs):
        return _write_out(apply(lambda s: tfn(_seq(s)), list(tup)), out)
    fn.__name__ = name
    return fn


vstack = row_stack = _joiner(torch.vstack, "vstack")
hstack = _joiner(torch.hstack, "hstack")
dstack = _joiner(torch.dstack, "dstack")
column_stack = _joiner(torch.column_stack, "column_stack")
concat = concatenate


def _split(t, sections, axis):
    if isinstance(sections, ndarray):
        sections = sections.asnumpy().tolist()
    if isinstance(sections, torch.Tensor):
        sections = sections.tolist()
    if isinstance(sections, int):
        n = t.shape[axis]
        if sections <= 0 or n % sections:
            raise MXNetError(f"split: array split does not result in an "
                             f"equal division ({n} into {sections})")
        return list(torch.tensor_split(t, sections, dim=axis))
    return list(torch.tensor_split(t, [int(i) for i in sections],
                                   dim=axis))


def split(ary, indices_or_sections, axis=0):
    """Split into `indices_or_sections` equal sections, or at the indices
    it lists (NumPy's meaning; torch's ``split`` takes sizes)."""
    return apply(lambda t: _split(_ops._t(t), indices_or_sections, axis),
                 ary)


def array_split(ary, indices_or_sections, axis=0):
    sec = indices_or_sections
    return apply(lambda t: list(torch.tensor_split(
        _ops._t(t), sec if isinstance(sec, int) else [int(i) for i in sec],
        dim=axis)), ary)


def hsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=1 if ary.ndim > 1 else 0)


def vsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=0)


def dsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=2)


# -----------------------------------------------------------------------
# JAX's delegate table: each name ported (a torch body of `_ops`) or
# raising by name
# -----------------------------------------------------------------------
_DELEGATE = [
    # elementwise math
    "add", "subtract", "multiply", "divide", "true_divide", "floor_divide",
    "mod", "remainder", "fmod", "power", "float_power", "negative", "positive",
    "absolute", "abs", "fabs", "sign", "rint", "conj", "conjugate",
    "exp", "expm1", "exp2", "log", "log2", "log10", "log1p",
    "sqrt", "cbrt", "square", "reciprocal",
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "arctan2",
    "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh",
    "degrees", "radians", "deg2rad", "rad2deg", "hypot",
    "maximum", "minimum", "fmax", "fmin", "clip",
    "ceil", "floor", "trunc", "round", "around", "fix",
    "logaddexp", "logaddexp2", "ldexp", "frexp", "copysign", "nextafter",
    "heaviside", "nan_to_num", "real", "imag", "angle", "i0", "sinc",
    "gcd", "lcm",
    # comparison / logic
    "equal", "not_equal", "less", "less_equal", "greater", "greater_equal",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "isfinite", "isinf", "isnan", "isneginf", "isposinf", "iscomplexobj",
    "isreal", "isrealobj", "iscomplex", "signbit",
    "array_equal", "array_equiv", "allclose", "isclose",
    # bitwise
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "invert",
    "left_shift", "right_shift",
    # reductions
    "sum", "prod", "mean", "std", "var", "min", "max", "amin", "amax",
    "nansum", "nanprod", "nanmean", "nanstd", "nanvar", "nanmin", "nanmax",
    "all", "any", "ptp", "median", "nanmedian", "average", "quantile",
    "percentile", "nanquantile", "nanpercentile", "count_nonzero",
    "argmax", "argmin", "nanargmax", "nanargmin",
    "cumsum", "cumprod", "nancumsum", "nancumprod",
    "diff", "ediff1d", "gradient", "trapezoid",
    # linalg-ish top-level
    "dot", "vdot", "inner", "outer", "tensordot", "kron", "trace", "cross",
    "matmul", "einsum", "convolve", "correlate",
    # shape manipulation
    "reshape", "ravel", "transpose", "swapaxes", "moveaxis", "rollaxis",
    "expand_dims", "squeeze", "broadcast_to", "broadcast_arrays",
    "atleast_1d", "atleast_2d", "atleast_3d",
    "flip", "fliplr", "flipud", "rot90", "roll", "repeat", "tile",
    "append", "trim_zeros", "flipud",
    "tril", "triu", "diag", "diagflat", "diagonal", "extract",
    # indexing / selection
    "take", "take_along_axis", "put_along_axis", "choose", "compress",
    "searchsorted", "digitize", "select", "piecewise", "indices",
    "unravel_index", "ravel_multi_index", "tril_indices", "triu_indices",
    "diag_indices",
    # sorting
    "sort", "argsort", "lexsort", "partition", "argpartition",
    # statistics
    "bincount", "histogram", "histogram2d", "histogramdd",
    "histogram_bin_edges",
    "corrcoef", "cov",
    # misc
    "interp", "pad", "flatnonzero", "vander", "ones_like",
    "result_type", "promote_types", "shape", "ndim", "size", "iscomplexobj",
    "insert", "delete", "resize", "setdiff1d", "union1d", "intersect1d",
    "isin", "in1d", "fill_diagonal",
    # long tail
    "apply_along_axis", "apply_over_axes", "divmod", "ix_", "modf",
    "packbits", "unpackbits", "poly", "polyadd", "polyder", "polydiv",
    "polyfit", "polyint", "polymul", "polysub", "polyval", "roots",
    "setxor1d", "spacing", "tril_indices_from", "unwrap",
]

_g = globals()
for _name in _DELEGATE:
    if _name in _g:          # defined above (creation, where, ...)
        continue
    if _name in IMPLS:
        _g[_name] = wrap_fn(IMPLS[_name], _name)
    elif _name not in ("put_along_axis", "fill_diagonal", "result_type",
                       "promote_types"):
        _g[_name] = unported(f"mx.np.{_name}", "A16")

#: the names of JAX's table the port raises on (ROADMAP.md A16)
UNPORTED = tuple(sorted(n for n in set(_DELEGATE)
                        if getattr(_g[n] if n in _g else None,
                                   "roadmap_item", None)))


def put_along_axis(arr, indices, values, axis):
    """Write `values` into `arr` at `indices` along `axis`, in place."""
    idx = _ops._t(indices._data if isinstance(indices, ndarray) else indices,
                  arr._data).long()
    val = values._data if isinstance(values, ndarray) else values

    def go(t):
        v = _ops._operand(val, t).to(t.dtype)
        if axis is None:
            flat = t.view(-1)
            flat.scatter_(0, idx.reshape(-1),
                          v.broadcast_to(idx.shape).reshape(-1))
        else:
            t.scatter_(axis, idx, v.broadcast_to(idx.shape).contiguous())
    arr._inplace(go)


def fill_diagonal(a, val, wrap=False):
    """Write `val` on the main diagonal of `a`, in place."""
    shape = a.shape
    if len(shape) == 2:
        step = shape[1] + 1
        end = None if wrap else shape[1] * shape[1]
    else:
        if len(set(shape)) != 1:
            raise MXNetError("fill_diagonal: all dimensions of an array of "
                             "more than 2 dimensions must be equal")
        step = 1 + int(_onp.cumprod(shape[:-1]).sum())
        end = None
    v = val._data if isinstance(val, ndarray) else val

    def go(t):
        sl = t.view(-1)[:end:step]
        vt = _ops._operand(v, t).to(t.dtype).reshape(-1)
        reps = -(-sl.numel() // builtins.max(1, vt.numel()))
        sl.copy_(vt.repeat(reps)[:sl.numel()])
    a._inplace(go)


def result_type(*arrays_and_dtypes):
    """The dtype NumPy's promotion gives (JAX's lattice: int32 with
    float32 is float32; Python scalars are weak)."""
    strong, weak = [], []
    for a in arrays_and_dtypes:
        if isinstance(a, ndarray):
            strong.append(a._data.dtype)
        elif isinstance(a, torch.Tensor):
            strong.append(a.dtype)
        elif isinstance(a, (builtins.bool, int, float, complex)):
            weak.append(type(a))
        else:
            strong.append(to_torch_dtype(a))
    if not strong:
        strong = [torch.complex64 if complex in weak else _default_tdt()
                  if float in weak else torch.int32 if int in weak
                  else torch.bool]
    r = strong[0]
    for d in strong[1:]:
        r = torch.promote_types(r, d)
    if float in weak and not (r.is_floating_point or r.is_complex):
        r = _default_tdt()
    elif int in weak and r == torch.bool:
        r = torch.int32
    return to_np_dtype(r)


def promote_types(type1, type2):
    return to_np_dtype(torch.promote_types(to_torch_dtype(type1),
                                           to_torch_dtype(type2)))


def may_share_memory(a, b, max_work=None):
    """Whether the two arrays' storage overlaps (a basic slice is a view
    of its array, as in MXNet)."""
    ta, tb = a._data, b._data
    if ta.device != tb.device:
        return False
    sa, sb = ta.untyped_storage(), tb.untyped_storage()
    return sa.data_ptr() == sb.data_ptr()


shares_memory = may_share_memory


def dtype(d):
    """NumPy's ``dtype``, with the port's `bfloat16`."""
    return bfloat16 if d == bfloat16 else _onp.dtype(d)


def bfloat16_cast(a):
    return a.astype(bfloat16)


def msort(a):
    """Sort along the first axis (NumPy removed it in 2.0)."""
    return sort(a, axis=0)  # noqa: F821


def alltrue(a, axis=None, **kwargs):
    return all(a, axis=axis, **kwargs)  # noqa: F821


def min_scalar_type(a):
    return _onp.min_scalar_type(a.asnumpy() if isinstance(a, ndarray)
                                else a)


trapz = wrap_fn(IMPLS["trapz"], "trapz")
acos = arccos                 # noqa: F821
acosh = arccosh               # noqa: F821
asin = arcsin                 # noqa: F821
asinh = arcsinh               # noqa: F821
atan = arctan                 # noqa: F821
atan2 = arctan2               # noqa: F821
atanh = arctanh               # noqa: F821
bitwise_invert = invert       # noqa: F821
bitwise_left_shift = left_shift   # noqa: F821
bitwise_right_shift = right_shift  # noqa: F821
permute_dims = transpose      # noqa: F821
pow = power                   # noqa: F821,A001
round_ = round                # noqa: F821


def _window(tfn):
    def fn(M, dtype=None, device=None, ctx=None):
        dt = to_torch_dtype(dtype) or _default_tdt()
        dev = _dev(device, ctx)
        if M < 1:
            return wrap(torch.zeros(0, dtype=dt, device=dev))
        if M == 1:
            return wrap(torch.ones(1, dtype=dt, device=dev))
        return wrap(tfn(M, periodic=False, dtype=torch.float32,
                        device=dev).to(dt))
    return fn


blackman = _window(torch.blackman_window)
hamming = _window(torch.hamming_window)
hanning = _window(torch.hann_window)


def diag_indices_from(arr):
    if arr.ndim < 2:
        raise MXNetError("diag_indices_from needs an array of at least "
                         f"2 dimensions, got {arr.ndim}-d")
    if len(set(arr.shape)) != 1:
        raise MXNetError("diag_indices_from needs a square array, got "
                         f"shape {arr.shape}")
    i = arange(arr.shape[0], dtype=int32, device=arr.device)
    return tuple(i for _ in range(arr.ndim))


def triu_indices_from(arr, k=0):
    if arr.ndim != 2:
        raise MXNetError(f"triu_indices_from needs a 2-d array, got "
                         f"{arr.ndim}-d")
    r = torch.triu_indices(arr.shape[0], arr.shape[1], k,
                           device=arr._data.device)
    return wrap(r[0]), wrap(r[1])


def from_dlpack(x):
    """An array over a DLPack producer's memory (`mx.dlpack`)."""
    from ..dlpack import from_dlpack as _fd
    return _fd(x)


def genfromtxt(*args, **kwargs):
    """NumPy's ``genfromtxt``, then onto the device."""
    return array(_onp.genfromtxt(*args, **kwargs))


def set_printoptions(*args, **kwargs):
    """For the host repr (printing goes through ``asnumpy``)."""
    _onp.set_printoptions(*args, **kwargs)


def get_include():
    return _onp.get_include()


from . import random  # noqa: E402,F401

linalg = UnportedModule("mx.np.linalg", "A16")
fft = UnportedModule("mx.np.fft", "A16")
ndarray = ndarray  # noqa: PLW0127 — re-export
