"""Gluon `Parameter` (counterpart of ``mxnet_tpu/gluon/parameter.py``).

The value is a ``torch.nn.Parameter`` made at initialization (`data()`);
every Gluon `Block` that holds the `Parameter` as an attribute registers
that tensor in its ``_parameters`` under the attribute's name, so torch's
``named_parameters()``, `convert.load_jax_params`, `parallel.TrainStep`
and the `Trainer` see it as they see any module's weight.  The shape may
hold 0 / -1 entries until the owning block's ``infer_shape`` runs on the
first call (``allow_deferred_init``).

``grad_req`` is MXNet's: ``"write"`` (each backward writes ``grad()``
afresh; torch alone would add to it), ``"add"`` (backward passes sum until
`zero_grad`) or ``"null"`` (no gradient: ``requires_grad=False``).
``lr_mult`` / ``wd_mult`` reach the optimizer through the `Trainer`.
A parameter of a plain ``torch.nn.Module`` inside a Gluon block is
adopted on `Block.collect_params` under its module path: the same tensor,
with ``lr_mult`` and ``grad_req`` of its own, filled by the block's
``initialize()`` like any other.
Row-sparse storage (``row_sparse_data``) waits for ROADMAP.md A16.
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from ..base import MXNetError
from ..device import Device, as_torch_device
from .. import autograd as _ag
from .. import initializer as _init

__all__ = ["Parameter", "Constant", "DeferredInitializationError",
           "torch_dtype"]


class DeferredInitializationError(MXNetError):
    pass


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name == "bfloat16":
        return torch.bfloat16
    return getattr(torch, np.dtype(name).name)


def _shape_known(shape) -> bool:
    return shape is not None and all(isinstance(s, int) and s > 0
                                     for s in shape)


class Parameter:
    def __init__(self, name: str = "weight", grad_req: str = "write",
                 shape=None, dtype="float32", lr_mult: float = 1.0,
                 wd_mult: float = 1.0, init=None, allow_deferred_init=False,
                 differentiable=True, stype="default",
                 grad_stype="default"):
        if stype != "default" or grad_stype != "default":
            raise MXNetError("row_sparse parameters and gradients are not "
                             "ported yet (ROADMAP.md A16)")
        self._name = name
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = torch_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._grad_req = grad_req if differentiable else "null"
        self._differentiable = differentiable
        self._data: Optional[torch.nn.Parameter] = None
        self._deferred_init = None      # (init, device, default_init)
        self._structure_key = None
        # (weak reference to a module, attribute) holding it: weak, so a
        # block and its parameters form no reference cycle and are freed
        # on their last reference, not at the next garbage collection
        self._owners = []
        self._pending_init = False      # adopted: initialize() fills it

    # -- adoption of a plain module's parameter -----------------------------
    @classmethod
    def adopt(cls, tensor: torch.nn.Parameter, name: str) -> "Parameter":
        """The Gluon `Parameter` of a plain module's `tensor` (made once,
        kept on the tensor)."""
        p = getattr(tensor, "_gluon_parameter", None)
        if p is None:
            p = cls(name, grad_req="write" if tensor.requires_grad
                    else "null", shape=tuple(tensor.shape),
                    dtype=tensor.dtype)
            p._data = tensor
            p._pending_init = True
            _ag.set_grad_req(tensor, p._grad_req)
            tensor._gluon_parameter = p
        return p

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_owners"] = [(m, a) for m, a in self._live_owners()]
        return state

    def __setstate__(self, state):
        # an unpickled value's write hook is inert (`autograd._WriteHook`):
        # arm a live one
        owners = state.pop("_owners", [])
        self.__dict__.update(state)
        self._owners = [(weakref.ref(m), a) for m, a in owners]
        if self._data is not None:
            _ag.set_grad_req(self._data, self._grad_req)

    def _live_owners(self):
        for ref, attr in self._owners:
            m = ref()
            if m is not None:
                yield m, attr

    def _attach(self, module, attr):
        self._owners.append((weakref.ref(module), attr))
        module._parameters[attr] = self._data

    def _detach(self, module, attr):
        self._owners = [(r, a) for r, a in self._owners
                        if not (r() is module and a == attr)]

    def _sync_owners(self):
        for m, attr in self._live_owners():
            m._parameters[attr] = self._data

    # -- identity -----------------------------------------------------------
    @property
    def name(self) -> str:
        return self._structure_key or self._name

    @name.setter
    def name(self, v):
        self._name = v

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if new_shape is None:
            return
        new_shape = tuple(new_shape)
        if self._shape is not None:
            matched = len(self._shape) == len(new_shape) and all(
                s in (0, -1) or s == n for s, n in zip(self._shape, new_shape))
            if not matched and _shape_known(self._shape):
                raise MXNetError(
                    f"cannot reset shape of {self.name} from {self._shape} "
                    f"to {new_shape}")
        self._shape = new_shape

    @property
    def stype(self):
        return "default"

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req!r}")
        self._grad_req = req if self._differentiable else "null"
        if self._data is not None:
            _ag.set_grad_req(self._data, self._grad_req)

    # -- init ---------------------------------------------------------------
    def initialize(self, init=None, device=None, ctx=None,
                   default_init=None, force_reinit=False):
        """Make (or, adopted, fill) the value on `device` (the current
        device by default: the card) with `init`, else this parameter's
        own ``init``, else `default_init`; deferred until the shape is
        known when ``allow_deferred_init``."""
        if self._data is not None and not force_reinit and \
                not self._pending_init:
            return
        device = device if device is not None else ctx
        if isinstance(device, (list, tuple)):
            device = device[0]
        dev = as_torch_device(device)
        if not _shape_known(self._shape):
            if not self.allow_deferred_init:
                raise MXNetError(
                    f"cannot initialize {self.name}: shape {self._shape} "
                    "unknown and deferred init not allowed")
            self._deferred_init = (init, dev, default_init)
            return
        self._finish_init(init, dev, default_init)

    def _finish_init(self, init, dev, default_init):
        initializer = init or self.init or default_init or _init.Uniform()
        initializer = _init.create(initializer) \
            if isinstance(initializer, str) else initializer
        if self._data is not None:       # adopted or re-initialized
            with torch.no_grad():
                if self._data.device != dev:
                    self._data.data = self._data.data.to(dev)
                initializer(self._name, self._data.data)
        else:
            data = torch.zeros(self._shape, dtype=self.dtype, device=dev)
            initializer(self._name, data)
            self._install(data)
        self._pending_init = False
        self._deferred_init = None

    def _install(self, value: torch.Tensor) -> None:
        """Make `value` (this parameter's shape and dtype, on the device
        it is to live on) the value of an uninitialized parameter."""
        self._data = torch.nn.Parameter(value)
        _ag.set_grad_req(self._data, self._grad_req)
        self._sync_owners()
        self._pending_init = False
        self._deferred_init = None

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not _shape_known(self._shape):
            raise DeferredInitializationError(
                f"shape of {self.name} still unknown: {self._shape}")
        init, dev, default_init = self._deferred_init
        self._finish_init(init, dev, default_init)

    # -- access -------------------------------------------------------------
    def _check(self):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name} deferred; run a forward pass or "
                    "call infer_shape first")
            raise MXNetError(f"parameter {self.name} not initialized; call "
                             ".initialize()")

    def data(self, device=None) -> torch.Tensor:
        """The value (the ``torch.nn.Parameter`` itself; on another
        `device`, a differentiable copy there)."""
        self._check()
        if device is not None:
            dev = as_torch_device(device)
            if dev != self._data.device:
                return self._data.to(dev)
        return self._data

    def list_data(self):
        return [self.data()]

    def row_sparse_data(self, row_id):
        raise MXNetError("row_sparse_data: row-sparse parameters are not "
                         "ported yet (ROADMAP.md A16)")

    list_row_sparse_data = row_sparse_data

    def grad(self, device=None, ctx=None) -> Optional[torch.Tensor]:
        """The gradient: zeros until a backward pass wrote one, None under
        ``grad_req="null"``."""
        self._check()
        if self._grad_req == "null":
            return None
        g = self._data.grad
        if g is None:
            g = torch.zeros_like(self._data)
        d = device if device is not None else ctx
        return g if d is None else g.to(as_torch_device(d))

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [Device(self.data().device)]

    list_device = list_ctx

    def set_data(self, data):
        """Copy `data` in, cast to this parameter's dtype; an
        uninitialized parameter takes its shape (and, not deferred, the
        current device)."""
        val = torch.as_tensor(data)
        if self._data is None:
            self.shape = tuple(val.shape)
            if self._deferred_init is not None:
                self._finish_deferred_init()
            else:
                self._install(val.detach().to(as_torch_device(None),
                                              self.dtype).clone())
                return
        with torch.no_grad():
            self._data.copy_(val.to(self._data.device, self._data.dtype))
        self._pending_init = False

    def zero_grad(self):
        if self._data is not None and self._data.grad is not None:
            self._data.grad.zero_()

    def reset_device(self, device):
        if isinstance(device, (list, tuple)):
            device = device[0]
        if self._data is not None:
            dev = as_torch_device(device)
            with torch.no_grad():
                self._data.data = self._data.data.to(dev)
                if self._data.grad is not None:
                    self._data.grad = self._data.grad.to(dev)

    reset_ctx = reset_device

    def cast(self, dtype):
        self.dtype = torch_dtype(dtype)
        if self._data is not None:
            with torch.no_grad():
                self._data.data = self._data.data.to(self.dtype)
                if self._data.grad is not None:
                    self._data.grad = self._data.grad.to(self.dtype)

    def var(self):
        return self.data()

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={str(self.dtype).replace('torch.', '')})")


class Constant(Parameter):
    """A parameter that is never trained (``grad_req="null"``)."""

    def __init__(self, value, name: str = "const"):
        if torch.is_tensor(value):
            value = value.detach().cpu().numpy()
        self.value = np.asarray(value)
        super().__init__(name=name, grad_req="null",
                         shape=self.value.shape, dtype=self.value.dtype,
                         init=_init.Constant(self.value),
                         differentiable=False)
