"""The `ndarray` array type of the port (counterpart of
``mxnet_tpu/ndarray/ndarray.py``): a handle over one ``torch.Tensor``.

The JAX package's `ndarray` holds a ``jax.Array`` in ``_data``; this one
holds a tensor there.  It is a wrapper, not a ``torch.Tensor`` subclass:
MXNet's attributes mean other things than torch's (``size`` is an int,
``dtype`` a NumPy dtype, ``sum(axis=)`` takes an axis, ``max(axis)``
returns values only), and a subclass's ``__torch_function__`` would run at
every op inside the models.  The models, `TrainStep`, the `Trainer` and
the kernels' dispatchers only ever see plain tensors: the Gluon, model and
training entry points unwrap an `ndarray` at the door and wrap their
tensor results on the way out (`accepts_ndarray`).

Semantics, MXNet's where they differ from torch's:

- *dtypes*: the port has no 64-bit switch, so it follows the JAX
  package's rule with x64 off: a float64 input becomes float32, an int64
  one int32, and every op's int64 / float64 result is narrowed the same
  way (index results such as ``argmax`` are int32); an explicit
  ``dtype="float64"`` raises (`base.check_x64_dtype`).  ``dtype`` is a
  NumPy dtype, and `bfloat16` the port's own dtype object (NumPy has no
  bfloat16 without ``ml_dtypes``); ``asnumpy()`` of a bfloat16 array is
  float32, an exact widening.
- *recording*: an op on arrays is recorded only inside
  ``autograd.record()``; outside it runs under ``torch.no_grad()`` where
  an input requires a gradient.  ``backward()`` of an array that was not
  recorded leaves every gradient as it was, as the JAX package does.
- *views*: basic slicing returns a view, so a write through it reaches
  the array it came from (MXNet's semantics; the JAX package copies).
  An in-place op on an array that is part of a recorded graph raises
  inside ``record()``, as MXNet does.
- *devices*: an op over arrays on two devices raises; nothing is copied
  quietly.
"""
from __future__ import annotations

import functools
import operator as _op
from typing import Optional

import numpy as _np
import torch

from .. import autograd as _ag
from ..base import MXNetError, check_x64_dtype
from ..device import Device, process_pinned_cpu, resolve_device

__all__ = ["ndarray", "NDArray", "bfloat16", "from_torch", "as_tensor",
           "to_torch_dtype", "to_np_dtype", "apply", "apply_entry",
           "accepts_ndarray",
           "unwrap", "wrap", "has_ndarray"]


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

class _BFloat16:
    """The bfloat16 dtype of ``mx.np``: NumPy has no bfloat16 of its own,
    so this object stands for it.  It compares equal to ``"bfloat16"``,
    to ``torch.bfloat16`` and to any dtype named bfloat16 (``ml_dtypes``'
    NumPy dtype where that package exists)."""

    name = "bfloat16"
    itemsize = 2
    kind = "f"

    def __eq__(self, other):
        if other is self or other is torch.bfloat16:
            return True
        if isinstance(other, str):
            return other == "bfloat16"
        return getattr(other, "name", None) == "bfloat16" or \
            getattr(getattr(other, "dtype", None), "name", None) == \
            "bfloat16"

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash("bfloat16")

    def __repr__(self):
        return "bfloat16"

    __str__ = __repr__


bfloat16 = _BFloat16()

_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64, torch.uint64: torch.uint32}
_TO_NP = {torch.float32: _np.dtype("float32"),
          torch.float16: _np.dtype("float16"),
          torch.float64: _np.dtype("float64"),
          torch.int8: _np.dtype("int8"), torch.int16: _np.dtype("int16"),
          torch.int32: _np.dtype("int32"), torch.int64: _np.dtype("int64"),
          torch.uint8: _np.dtype("uint8"), torch.uint16: _np.dtype("uint16"),
          torch.uint32: _np.dtype("uint32"),
          torch.uint64: _np.dtype("uint64"), torch.bool: _np.dtype("bool"),
          torch.complex64: _np.dtype("complex64"),
          torch.complex128: _np.dtype("complex128")}
_BY_NAME = {str(v): k for k, v in _TO_NP.items()}
_BY_NAME["bfloat16"] = torch.bfloat16


def to_torch_dtype(dtype) -> Optional[torch.dtype]:
    """A NumPy / torch / string / Python dtype as the torch dtype the port
    stores it in: None stays None, ``int`` and int64 become int32; an
    explicit float64 or complex128 (``float`` too) raises
    (`base.check_x64_dtype`)."""
    if dtype is None:
        return None
    check_x64_dtype(dtype)
    if isinstance(dtype, torch.dtype):
        return _NARROW.get(dtype, dtype)
    if dtype is int:
        return torch.int32
    if dtype is bool:
        return torch.bool
    if isinstance(dtype, _BFloat16):
        return torch.bfloat16
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    if name is None:
        name = _np.dtype(dtype).name
    if name == "bool_":
        name = "bool"
    t = _BY_NAME.get(name)
    if t is None:
        t = _BY_NAME.get(_np.dtype(name).name)
    if t is None:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _NARROW.get(t, t)


def to_np_dtype(t: torch.dtype):
    """The NumPy dtype of a torch dtype (`bfloat16` for bfloat16)."""
    if t == torch.bfloat16:
        return bfloat16
    return _TO_NP[t]


# ---------------------------------------------------------------------------
# wrapping and unwrapping
# ---------------------------------------------------------------------------

def wrap(t: torch.Tensor) -> "ndarray":
    """`t` as an `ndarray` (no copy), a 64-bit result narrowed to 32."""
    n = _NARROW.get(t.dtype)
    if n is not None:
        t = t.to(n)
    out = object.__new__(ndarray)
    out._data = t
    return out


def _wrap_out(obj):
    if isinstance(obj, torch.Tensor):
        return wrap(obj)
    if isinstance(obj, tuple):
        return tuple(_wrap_out(o) for o in obj)
    if isinstance(obj, list):
        return [_wrap_out(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _wrap_out(v) for k, v in obj.items()}
    return obj


def has_ndarray(obj) -> bool:
    """Whether `obj` is an `ndarray` or a tuple, list or dict holding one
    (at any depth)."""
    if isinstance(obj, ndarray):
        return True
    if isinstance(obj, (tuple, list)):
        return any(has_ndarray(o) for o in obj)
    if isinstance(obj, dict):
        return any(has_ndarray(o) for o in obj.values())
    return False


def unwrap(obj, leaves=None):
    """`obj` with every `ndarray` (at any depth of tuples, lists and
    dicts) replaced by its tensor; the tensors are appended to
    `leaves`."""
    if isinstance(obj, ndarray):
        if leaves is not None:
            leaves.append(obj._data)
        return obj._data
    if isinstance(obj, tuple):
        return tuple(unwrap(o, leaves) for o in obj)
    if isinstance(obj, list):
        return [unwrap(o, leaves) for o in obj]
    if isinstance(obj, dict):
        return {k: unwrap(v, leaves) for k, v in obj.items()}
    return obj


def _check_devices(leaves):
    if len(leaves) > 1:
        d = leaves[0].device
        for t in leaves[1:]:
            if t.device != d:
                raise MXNetError(
                    f"arrays on {d} and {t.device} in one op; move one "
                    "with as_in_ctx / to_device first")


def _grad_scope(leaves, inner_params=False):
    """``torch.no_grad()`` outside ``autograd.record()`` (MXNet records
    nothing there) where an input requires a gradient, or where the call
    holds parameters of its own (`inner_params`, a Block); else None."""
    if _ag.is_recording() or not torch.is_grad_enabled():
        return None
    if inner_params or any(t.requires_grad for t in leaves):
        return torch.no_grad()
    return None


def _apply(fn, args, kwargs, inner_params):
    leaves = []
    targs = unwrap(args, leaves)
    tkw = unwrap(kwargs, leaves) if kwargs else kwargs
    _check_devices(leaves)
    scope = _grad_scope(leaves, inner_params)
    if scope is None:
        return _wrap_out(fn(*targs, **tkw))
    with scope:
        return _wrap_out(fn(*targs, **tkw))


def apply(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on tensors: every `ndarray` among the
    arguments (inside tuples, lists and dicts too) is unwrapped, the
    devices checked, the call recorded only inside ``autograd.record()``,
    and every tensor of the result wrapped (counterpart of JAX's
    ``apply_op`` / ``_wrap_outputs``; torch records, so there is no
    tape)."""
    return _apply(fn, args, kwargs, False)


def apply_entry(fn, *args, **kwargs):
    """`apply` for an entry point that holds parameters of its own (a
    Block, a model's decode): outside ``autograd.record()`` it runs under
    ``torch.no_grad()`` whatever its inputs."""
    return _apply(fn, args, kwargs, True)


def accepts_ndarray(fn):
    """Decorate an entry point on tensors so that it takes `ndarray`s too:
    given one among its arguments it unwraps them all, runs under the
    recording rule of `apply_entry`, and wraps its tensor results; given
    none it is `fn` as it was."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if has_ndarray(args) or (kwargs and has_ndarray(kwargs)):
            return apply_entry(fn, *args, **kwargs)
        return fn(*args, **kwargs)
    return entry


def as_tensor(x):
    """The tensor behind an `ndarray`; anything else as it is."""
    return x._data if isinstance(x, ndarray) else x


def from_torch(t: torch.Tensor, device=None) -> "ndarray":
    """Wrap tensor `t` (no copy: the array shares its storage and its
    graph), moved to `device` first when one is given (counterpart of
    JAX's ``from_jax``)."""
    if device is not None:
        t = t.to(resolve_device(device))
    return wrap(t)


def _write_out(result: "ndarray", out: Optional["ndarray"]):
    """``out=``: `result` written into `out`'s buffer."""
    if out is None:
        return result
    out._inplace(lambda t: t.copy_(result._data))
    return out


_mnp = None


def _np_mod():
    global _mnp
    if _mnp is None:
        from .. import numpy as m
        _mnp = m
    return _mnp


def _scalar(v):
    """A NumPy scalar as the Python number torch takes."""
    return v.item() if isinstance(v, _np.generic) else v


def _binop(fn, a, b):
    av = a._data
    if isinstance(b, ndarray):
        bv = b._data
        leaves = (av, bv)
        if av.device != bv.device:
            _check_devices(leaves)
    else:
        bv = _scalar(b)
        if isinstance(bv, _np.ndarray):
            bv = torch.as_tensor(bv, device=av.device)
        leaves = (av,)
    scope = _grad_scope(leaves)
    if scope is None:
        return wrap(fn(av, bv))
    with scope:
        return wrap(fn(av, bv))


def _rbinop(fn, a, b):
    """``b <op> a`` for a `b` that is not an array (`fn` a function of
    the operator module, so a Python scalar on the left takes torch's
    reflected operator)."""
    return _binop(lambda x, y: fn(y, x), a, b)


def _unary(fn, a):
    av = a._data
    scope = _grad_scope((av,))
    if scope is None:
        return wrap(fn(av))
    with scope:
        return wrap(fn(av))


def _true_divide(a, b):
    return torch.true_divide(a, b)


def _floordiv(a, b):
    return torch.floor_divide(a, b)


# ---------------------------------------------------------------------------
# the array
# ---------------------------------------------------------------------------

class ndarray:
    """An N-dimensional array on a device, over one ``torch.Tensor``
    (``_data``).  ``ndarray(data)`` copies `data` (a sequence, a NumPy
    array, a tensor or an array) onto the current device; `from_torch` and
    ``mx.np.asarray`` of a tensor wrap with no copy."""

    __slots__ = ("_data", "__weakref__")

    # NumPy scalars on the left defer to the array's reflected operators
    __array_priority__ = 1000.0

    def __init__(self, data=None, device=None, dtype=None):
        if isinstance(data, ndarray):
            data = data._data
        self._data = _np_mod().array(data, dtype=dtype,
                                     device=device)._data

    # -- properties ----------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return to_np_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def device(self) -> Device:
        return Device(self._data.device)

    ctx = context = device

    @property
    def T(self) -> "ndarray":
        return self.transpose()

    @property
    def mT(self) -> "ndarray":
        if self.ndim < 2:
            raise ValueError(f"matrix transpose requires at least 2 "
                             f"dimensions; got {self.ndim}")
        return _unary(lambda t: t.transpose(-1, -2), self)

    @property
    def stype(self) -> str:
        return "default"

    @property
    def itemsize(self) -> int:
        return self._data.element_size()

    @property
    def nbytes(self) -> int:
        return self._data.numel() * self._data.element_size()

    @property
    def grad(self) -> Optional["ndarray"]:
        g = self._data.grad
        return None if g is None else wrap(g)

    # -- engine --------------------------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    # -- conversion ----------------------------------------------------------
    def asnumpy(self) -> _np.ndarray:
        """A host copy, writable; a bfloat16 array comes back as float32
        (exact: every bfloat16 is a float32)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def asscalar(self):
        return self.item()

    def item(self, *args):
        return self.asnumpy().item(*args)

    def tolist(self):
        return self.asnumpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __dlpack__(self, **kwargs):
        return self._data.detach().__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __index__(self):
        if self.size != 1 or self._data.is_floating_point():
            raise TypeError("only integer scalar arrays can be converted "
                            "to a scalar index")
        return int(self.item())

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an ndarray with multiple "
                             "elements is ambiguous.")
        return bool(self.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return repr(self.asnumpy()).replace("array", "ndarray", 1) + \
            f" @{self.device}"

    def __str__(self):
        return str(self.asnumpy())

    def __hash__(self):
        return id(self)

    def __reduce__(self):
        return (_rebuild, (self.asnumpy(), str(self.dtype),
                           self._data.device.type))

    # -- devices and copies --------------------------------------------------
    def to_device(self, device) -> "ndarray":
        return wrap(self._data.to(resolve_device(device)))

    as_in_ctx = as_in_context = copyto_device = to_device

    def copy(self) -> "ndarray":
        return _unary(torch.clone, self)

    __copy__ = copy

    def copyto(self, other):
        """Copy into the array `other` (cast and broadcast to its dtype and
        shape), or onto the device `other`."""
        if isinstance(other, ndarray):
            src = self._data.to(other._data.device)
            other._inplace(lambda t: t.copy_(src.broadcast_to(t.shape)))
            return other
        return self.to_device(other)

    def astype(self, dtype, copy=True) -> "ndarray":
        dt = to_torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return _unary(lambda t: t.to(dt), self)

    def as_np_ndarray(self):
        return self

    as_nd_ndarray = as_np_ndarray

    # -- autograd ------------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Make the array a variable: detached from any earlier graph, with
        gradient request `grad_req` ("write", "add" or "null") and a zero
        gradient buffer at once."""
        if stype not in (None, "default"):
            raise MXNetError(f"{stype} gradients are not ported (ROADMAP "
                             "A16); gradients are dense")
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        t = self._data.detach()
        if not (t.is_floating_point() or t.is_complex()):
            if grad_req != "null":
                raise MXNetError(f"attach_grad: a {self.dtype} array takes "
                                 "no gradient")
        self._data = t
        _ag.set_grad_req(t, grad_req)
        if grad_req != "null":
            t.grad = torch.zeros_like(t)

    def drop_grad(self):
        t = self._data
        if t.is_leaf:
            _ag.set_grad_req(t, "null")

    def detach(self) -> "ndarray":
        return wrap(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Gradients of this array into its variables' ``.grad`` (a
        non-scalar array takes a gradient of ones).  An array that was not
        recorded changes no gradient."""
        if not self._data.requires_grad:
            return
        _ag.backward(self._data, None if out_grad is None else
                     [as_tensor(out_grad)], retain_graph=retain_graph,
                     train_mode=train_mode)

    def zero_grad(self):
        g = self._data.grad
        if g is not None:
            g.zero_()

    # -- in-place writes -----------------------------------------------------
    def _inplace(self, fn):
        """Run `fn` on the tensor in place: raises inside ``record()`` on an
        array that is part of a recorded graph (MXNet's rule); elsewhere it
        writes under ``no_grad``."""
        t = self._data
        if t.requires_grad:
            if _ag.is_recording():
                raise MXNetError(
                    "Inplace operations (+=, -=, x[:]=, etc) are not "
                    "supported when recording with autograd")
            with torch.no_grad():
                fn(t)
        else:
            fn(t)

    def _inplace_op(self, fn, other):
        v = as_tensor(_scalar(other))
        if isinstance(v, _np.ndarray):
            v = torch.as_tensor(v, device=self._data.device)
        if isinstance(v, torch.Tensor) and v.device != self._data.device:
            _check_devices([self._data, v])

        def go(t):
            r = fn(t, v)
            t.copy_(r)
        self._inplace(go)
        return self

    def __iadd__(self, o):
        return self._inplace_op(torch.add, o)

    def __isub__(self, o):
        return self._inplace_op(torch.sub, o)

    def __imul__(self, o):
        return self._inplace_op(torch.mul, o)

    def __itruediv__(self, o):
        return self._inplace_op(_true_divide, o)

    def __ifloordiv__(self, o):
        return self._inplace_op(_floordiv, o)

    def __imod__(self, o):
        return self._inplace_op(torch.remainder, o)

    def __ipow__(self, o):
        return self._inplace_op(torch.pow, o)

    # -- indexing ------------------------------------------------------------
    @staticmethod
    def _key(key):
        if isinstance(key, ndarray):
            return key._data
        if isinstance(key, tuple):
            return tuple(k._data if isinstance(k, ndarray) else k
                         for k in key)
        return key

    def __getitem__(self, key):
        k = self._key(key)
        return _unary(lambda t: t[k], self)

    def __setitem__(self, key, value):
        k = self._key(key)
        v = as_tensor(_scalar(value))
        if not isinstance(v, torch.Tensor) and not isinstance(
                v, (int, float, bool, complex)):
            v = torch.as_tensor(_np.asarray(v), device=self._data.device)

        def go(t):
            t[k] = v.to(t.dtype) if isinstance(v, torch.Tensor) else v
        self._inplace(go)

    # -- operators -----------------------------------------------------------
    def __add__(self, o):
        return _binop(torch.add, self, o)

    def __radd__(self, o):
        return _rbinop(_op.add, self, o)

    def __sub__(self, o):
        return _binop(torch.sub, self, o)

    def __rsub__(self, o):
        return _rbinop(_op.sub, self, o)

    def __mul__(self, o):
        return _binop(torch.mul, self, o)

    def __rmul__(self, o):
        return _rbinop(_op.mul, self, o)

    def __truediv__(self, o):
        return _binop(_true_divide, self, o)

    def __rtruediv__(self, o):
        return _rbinop(_op.truediv, self, o)

    def __floordiv__(self, o):
        return _binop(_floordiv, self, o)

    def __rfloordiv__(self, o):
        return _rbinop(_op.floordiv, self, o)

    def __mod__(self, o):
        return _binop(torch.remainder, self, o)

    def __rmod__(self, o):
        return _rbinop(_op.mod, self, o)

    def __pow__(self, o):
        return _binop(torch.pow, self, o)

    def __rpow__(self, o):
        return _rbinop(_op.pow, self, o)

    def __matmul__(self, o):
        return _binop(torch.matmul, self, o)

    def __rmatmul__(self, o):
        return _rbinop(_op.matmul, self, o)

    def __neg__(self):
        return _unary(torch.neg, self)

    def __pos__(self):
        return self

    def __abs__(self):
        return _unary(torch.abs, self)

    def __invert__(self):
        return _unary(torch.bitwise_not, self)

    def __eq__(self, o):
        return _binop(torch.eq, self, o)

    def __ne__(self, o):
        return _binop(torch.ne, self, o)

    def __lt__(self, o):
        return _binop(torch.lt, self, o)

    def __le__(self, o):
        return _binop(torch.le, self, o)

    def __gt__(self, o):
        return _binop(torch.gt, self, o)

    def __ge__(self, o):
        return _binop(torch.ge, self, o)

    def __and__(self, o):
        return _binop(torch.bitwise_and, self, o)

    def __rand__(self, o):
        return _rbinop(_op.and_, self, o)

    def __or__(self, o):
        return _binop(torch.bitwise_or, self, o)

    def __ror__(self, o):
        return _rbinop(_op.or_, self, o)

    def __xor__(self, o):
        return _binop(torch.bitwise_xor, self, o)

    def __rxor__(self, o):
        return _rbinop(_op.xor, self, o)

    def __lshift__(self, o):
        return _binop(torch.bitwise_left_shift, self, o)

    def __rshift__(self, o):
        return _binop(torch.bitwise_right_shift, self, o)

    # -- NumPy's method surface (the functions of mx.np) ---------------------
    def sum(self, axis=None, dtype=None, out=None, keepdims=False):
        return _np_mod().sum(self, axis=axis, dtype=dtype, out=out,
                             keepdims=keepdims)

    def mean(self, axis=None, dtype=None, out=None, keepdims=False):
        return _np_mod().mean(self, axis=axis, dtype=dtype, out=out,
                              keepdims=keepdims)

    def max(self, axis=None, out=None, keepdims=False):
        return _np_mod().max(self, axis=axis, out=out, keepdims=keepdims)

    def min(self, axis=None, out=None, keepdims=False):
        return _np_mod().min(self, axis=axis, out=out, keepdims=keepdims)

    def prod(self, axis=None, dtype=None, out=None, keepdims=False):
        return _np_mod().prod(self, axis=axis, dtype=dtype, out=out,
                              keepdims=keepdims)

    def std(self, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
        return _np_mod().std(self, axis=axis, dtype=dtype, out=out,
                             ddof=ddof, keepdims=keepdims)

    def var(self, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
        return _np_mod().var(self, axis=axis, dtype=dtype, out=out,
                             ddof=ddof, keepdims=keepdims)

    def argmax(self, axis=None, out=None, keepdims=False):
        return _np_mod().argmax(self, axis=axis, out=out, keepdims=keepdims)

    def argmin(self, axis=None, out=None, keepdims=False):
        return _np_mod().argmin(self, axis=axis, out=out, keepdims=keepdims)

    def cumsum(self, axis=None, dtype=None, out=None):
        return _np_mod().cumsum(self, axis=axis, dtype=dtype, out=out)

    def all(self, axis=None, out=None, keepdims=False):
        return _np_mod().all(self, axis=axis, out=out, keepdims=keepdims)

    def any(self, axis=None, out=None, keepdims=False):
        return _np_mod().any(self, axis=axis, out=out, keepdims=keepdims)

    def nonzero(self):
        return _np_mod().nonzero(self)

    def sort(self, axis=-1, kind=None, order=None):
        return _np_mod().sort(self, axis=axis)

    def argsort(self, axis=-1, kind=None, order=None):
        return _np_mod().argsort(self, axis=axis)

    def diag(self, k=0):
        return _np_mod().diag(self, k)

    def flip(self, axis=None):
        return _np_mod().flip(self, axis)

    def clip(self, a_min=None, a_max=None, out=None):
        return _np_mod().clip(self, a_min, a_max, out=out)

    def round(self, decimals=0, out=None):
        return _np_mod().round(self, decimals, out=out)

    def abs(self):
        return self.__abs__()

    def sqrt(self):
        return _unary(torch.sqrt, self)

    def exp(self):
        return _unary(torch.exp, self)

    def log(self):
        return _unary(torch.log, self)

    def sign(self):
        return _unary(torch.sign, self)

    def dot(self, b, out=None):
        return _np_mod().dot(self, b, out=out)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if kwargs.get("order", "C") != "C":
            raise MXNetError("reshape: only order='C' is supported")
        return _unary(lambda t: t.reshape(shape), self)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list,
                                                   type(None))):
            axes = axes[0]
        return _np_mod().transpose(self, axes or None)

    def swapaxes(self, a1, a2):
        return _unary(lambda t: t.transpose(a1, a2), self)

    def flatten(self, order="C"):
        return self.reshape((-1,))

    ravel = flatten

    def squeeze(self, axis=None):
        return _np_mod().squeeze(self, axis)

    def expand_dims(self, axis):
        return _np_mod().expand_dims(self, axis)

    def repeat(self, repeats, axis=None):
        return _np_mod().repeat(self, repeats, axis=axis)

    def tile(self, reps):
        return _np_mod().tile(self, reps)

    def take(self, indices, axis=None, mode="clip"):
        return _np_mod().take(self, indices, axis=axis, mode=mode)

    def broadcast_to(self, shape):
        return _np_mod().broadcast_to(self, shape)

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def split(self, indices_or_sections, axis=0):
        return _np_mod().split(self, indices_or_sections, axis=axis)

    def slice_axis(self, axis, begin, end):
        idx = [slice(None)] * self.ndim
        idx[axis] = slice(begin, end)
        return self[tuple(idx)]

    def pad(self, pad_width, mode="constant", **kwargs):
        return _np_mod().pad(self, pad_width, mode=mode, **kwargs)

    def norm(self, ord=None, axis=None, keepdims=False):
        raise MXNetError("norm is mx.np.linalg's, which is not ported "
                         "(ROADMAP A16)")

    def tostype(self, stype):
        if stype != "default":
            raise MXNetError("sparse storage is not ported (ROADMAP A16); "
                             "arrays are dense")
        return self

    def full_like(self, fill_value):
        return _np_mod().full_like(self, fill_value)


NDArray = ndarray   # MXNet 1.x's name


def _rebuild(a, dtype, device_type):
    """Unpickle: the array on the device type it left, except in a process
    pinned to the CPU (`device.pin_process_cpu`), where it stays there."""
    t = torch.from_numpy(a)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    if process_pinned_cpu():
        device_type = "cpu"
    return wrap(t.to(device_type))

