"""Gluon `Block` / `HybridBlock` (counterpart of
``mxnet_tpu/gluon/block.py``) as subclasses of ``torch.nn.Module``.

A `Parameter` assigned as an attribute is registered under that name and
its tensor appears in the module's ``_parameters``; a child `Block` or
plain ``torch.nn.Module`` is a torch submodule.  So `collect_params`
gives the JAX package's dotted names (own parameters first, then the
children's in registration order), and they equal torch's
``named_parameters()``: a plain ``torch.nn.Module`` child a user puts
inside a block contributes its parameters under its module path
(`Parameter.adopt`); the port's models are blocks throughout and need no
adoption.

Calling a block: its plain torch children follow MXNet's global training
flag (`autograd.is_training`, on inside ``autograd.record()``), deferred
parameters take their shapes from the first input (``infer_shape``),
then the forward pre-hooks, ``forward`` and the forward hooks run
(torch's hooks, with JAX's ``hook(block, args)`` / ``hook(block, args,
out)`` signatures; the handle's ``detach()`` removes one).

``hybridize`` is accepted with JAX's keywords and changes no result: the
block runs eagerly (capturing it as a CUDA graph waits for ROADMAP.md
A8).  `save_parameters` / `load_parameters` read and write the JAX
package's ``.npz`` (bf16 entries under the ``__bf16__`` tag), so a file
written by either package loads into the other.  The ``"params"``
binary format, ``export``, ``optimize_for`` and `SymbolBlock` wait for
A16.
"""
from __future__ import annotations

import re
import warnings
from collections import OrderedDict
from typing import Any, Dict, Optional

import torch

from ..base import MXNetError
from .. import autograd as _ag
from .. import random as _rng
from ..ndarray.ndarray import accepts_ndarray
from ..util import load_arrays, save_arrays
from .parameter import Parameter, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock", "functional_call"]


def _a16(what: str) -> MXNetError:
    return MXNetError(f"{what} is not ported yet (ROADMAP.md A16)")


def _check_load_dtype(name, v, p):
    if v.dtype != p.dtype:
        raise MXNetError(
            f"parameter {name}: file dtype {v.dtype} != parameter dtype "
            f"{p.dtype}; pass cast_dtype=True to cast on load")


def _handle(h):
    h.detach = h.remove
    return h


class Block(torch.nn.Module):
    """Base class of Gluon layers and models."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()

    # -- registration --------------------------------------------------------
    def __setattr__(self, name, value):
        reg = self.__dict__.get("_reg_params")
        if reg is not None:
            existing = reg.get(name, self._modules.get(name))
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)):
                raise TypeError(
                    f"Changing attribute type for {name} from "
                    f"{type(existing)} to {type(value)} is not allowed.")
        if isinstance(value, Parameter):
            if value._name == "weight" and name != "weight":
                value._name = name
            old = reg.get(name)
            if old is not None:
                old._detach(self, name)
            reg[name] = value
            object.__setattr__(self, name, value)
            value._attach(self, name)
            return
        if reg is not None and name in reg and value is None:
            reg.pop(name)._detach(self, name)
            self._parameters.pop(name, None)
        super().__setattr__(name, value)

    def __delattr__(self, name):
        reg = self.__dict__.get("_reg_params")
        if reg is not None and name in reg:
            reg.pop(name)._detach(self, name)
            self._parameters.pop(name, None)
            object.__delattr__(self, name)
            return
        super().__delattr__(name)

    def register_child(self, block: torch.nn.Module,
                       name: Optional[str] = None):
        self.add_module(name or str(len(self._modules)), block)

    register_block = register_child

    def _child_items(self):
        return list(self._modules.items())

    def _child_blocks(self):
        return [c for _, c in self._child_items()]

    # -- params --------------------------------------------------------------
    @property
    def params(self) -> Dict[str, Parameter]:
        return dict(self._reg_params)

    def collect_params(self, select: Optional[str] = None
                       ) -> "OrderedDict[str, Parameter]":
        """Every parameter under its dotted path; `select` keeps the names
        its regular expression finds."""
        self._check_container_with_block()
        out: "OrderedDict[str, Parameter]" = OrderedDict()
        _collect(self, out, "")
        if select is not None:
            pat = re.compile(select)
            out = OrderedDict((k, v) for k, v in out.items()
                              if pat.search(k))
        return out

    def _check_container_with_block(self):
        def _find(data):
            if isinstance(data, (list, tuple)):
                return any(_find(e) for e in data)
            if isinstance(data, dict):
                return any(_find(v) for v in data.values())
            return isinstance(data, Block)

        for k, v in self.__dict__.items():
            if isinstance(v, (list, tuple, dict)) and not k.startswith("_") \
                    and _find(v):
                warnings.warn(
                    f"'{type(self).__name__}.{k}' is a container with "
                    "Blocks. Note that Blocks inside the list, tuple or dict "
                    "will not be registered automatically. Make sure to "
                    "register them using register_child() or switching to "
                    "nn.Sequential/nn.HybridSequential instead.",
                    stacklevel=3)

    def initialize(self, init=None, device=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter (on `device`, by default the
        current device: the card) with `init` where it has no initializer
        of its own; a parameter with no known shape waits for the first
        call."""
        from .. import initializer as _init
        device = device if device is not None else ctx
        default = _init.Uniform()
        for p in self.collect_params().values():
            p.initialize(init=None if p.init is not None else init,
                         device=device, default_init=init or default,
                         force_reinit=force_reinit)
        return self

    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def zero_grad(self, set_to_none: bool = False):
        for p in self.collect_params().values():
            p.zero_grad()

    def reset_device(self, device):
        for p in self.collect_params().values():
            p.reset_device(device)

    reset_ctx = reset_device

    def setattr(self, name, value):
        for p in self.collect_params().values():
            setattr(p, name, value)

    def share_parameters(self, shared: Dict[str, Parameter]):
        """Rebind the parameters named in `shared` (``collect_params``
        names) to those objects: the blocks then hold the same
        `Parameter`."""
        _share(self, shared, "")
        return self

    # -- persistence ---------------------------------------------------------
    def save_parameters(self, filename: str, deduplicate: bool = False,
                        format: str = "npz"):
        if format != "npz":
            raise _a16(f"save_parameters(format={format!r})")
        arrays, seen = {}, set()
        for name, p in self.collect_params().items():
            if p._data is None or (deduplicate and id(p) in seen):
                continue
            seen.add(id(p))
            arrays[name] = p._data
        save_arrays(filename, arrays)

    def load_parameters(self, filename: str, device=None, ctx=None,
                        allow_missing=False, ignore_extra=False,
                        cast_dtype=False, dtype_source="current"):
        """Load a `.npz` written by `save_parameters` or by the JAX
        package (``arg:`` / ``aux:`` prefixes dropped).  `cast_dtype`
        casts each value to the parameter's dtype (``dtype_source=
        "current"``) or re-types the parameter (``"saved"``)."""
        if dtype_source not in ("current", "saved"):
            raise MXNetError(f"dtype_source must be 'current' or 'saved', "
                             f"got {dtype_source!r}")
        try:
            loaded = load_arrays(filename)
        except ValueError as e:
            raise _a16(f"loading {filename} (not an .npz: the binary "
                       f"'params' format)") from e
        loaded = {(k[4:] if k.startswith(("arg:", "aux:")) else k): v
                  for k, v in loaded.items()}
        params = self.collect_params()
        loaded_objs = {id(params[n]) for n in loaded if n in params}
        for name, p in params.items():
            if name not in loaded:
                if id(p) in loaded_objs:
                    continue
                if not allow_missing:
                    raise MXNetError(f"parameter {name} missing in "
                                     f"{filename}")
                continue
            v = loaded[name]
            if cast_dtype:
                if dtype_source == "saved":
                    p.cast(v.dtype)
            else:
                _check_load_dtype(name, v, p)
            p.set_data(v)
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError(f"file {filename} has extra parameters "
                                 f"{sorted(extra)}")
        return self

    def load_dict(self, param_dict, device=None, allow_missing=False,
                  ignore_extra=False, cast_dtype=False):
        params = self.collect_params()
        for name, p in params.items():
            if name in param_dict:
                v = param_dict[name]
                if isinstance(v, Parameter):
                    v = v.data()
                v = torch.as_tensor(v)
                if not cast_dtype:
                    _check_load_dtype(name, v, p)
                p.set_data(v)
            elif not allow_missing:
                raise MXNetError(f"parameter {name} missing")
        if not ignore_extra:
            extra = set(param_dict) - set(params)
            if extra:
                raise MXNetError(f"extra parameters {sorted(extra)}")
        return self

    # -- hooks ---------------------------------------------------------------
    def register_forward_pre_hook(self, hook, **kwargs):
        return _handle(super().register_forward_pre_hook(hook, **kwargs))

    def register_forward_hook(self, hook, **kwargs):
        return _handle(super().register_forward_hook(hook, **kwargs))

    def register_op_hook(self, callback, monitor_all=False):
        raise _a16("register_op_hook")

    # -- call ----------------------------------------------------------------
    def infer_shape(self, *args):
        """Blocks with deferred parameters set their shapes here."""
        raise DeferredInitializationError(
            f"{type(self).__name__} has deferred parameters but no "
            "infer_shape method")

    def _maybe_infer_shapes(self, *args):
        deferred = [p for p in self._reg_params.values()
                    if p._deferred_init is not None]
        if deferred:
            self.infer_shape(*args)
            for p in deferred:
                p._finish_deferred_init()

    @accepts_ndarray
    def __call__(self, *args, **kwargs):
        """Run `forward`.  Given an `ndarray` among the arguments (inside
        tuples, lists and dicts too), the block unwraps them all and its
        `forward` sees plain tensors; its tensor results come back as
        arrays, recorded only inside ``autograd.record()`` (MXNet's rule:
        outside it the call runs under ``torch.no_grad()``)."""
        flag = _ag.is_training()
        if self.training != flag:
            self.train(flag)
        self._maybe_infer_shapes(*args)
        return super().__call__(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def hybridize(self, active=True, **kwargs):
        """Accepted; the block runs eagerly, so no result changes."""
        return self

    def summary(self, *inputs):
        lines = [f"{type(self).__name__}:"]
        for name, p in self.collect_params().items():
            lines.append(f"  {name}: {p.shape} "
                         f"{str(p.dtype).replace('torch.', '')}")
        print("\n".join(lines))


def _collect(module, out, prefix):
    if isinstance(module, Block):
        for name, p in module._reg_params.items():
            p._structure_key = prefix + name
            out[prefix + name] = p
    else:
        for name, t in module._parameters.items():
            if t is not None:
                p = Parameter.adopt(t, name)
                p._structure_key = prefix + name
                out[prefix + name] = p
    for cname, child in module._modules.items():
        if child is not None:
            _collect(child, out, prefix + cname + ".")


def _share(module, shared, prefix):
    if isinstance(module, Block):
        for name in list(module._reg_params):
            if prefix + name in shared:
                setattr(module, name, shared[prefix + name])
    for cname, child in module._modules.items():
        if child is not None:
            _share(child, shared, prefix + cname + ".")


class HybridBlock(Block):
    """A `Block` whose ``hybridize`` JAX compiles to one program; here it
    runs eagerly and ``hybridize`` takes JAX's keywords and changes
    nothing."""

    def hybridize(self, active=True, static_alloc=True, static_shape=True,
                  backend=None, backend_opts=None, inline_limit=2,
                  forward_bulk_size=None, backward_bulk_size=None,
                  **kwargs):
        if backend is not None:
            raise _a16(f"hybridize(backend={backend!r}) (subgraph "
                       f"backends)")
        return self

    def optimize_for(self, x, *args, backend=None, **kwargs):
        raise _a16("optimize_for")

    def export(self, path: str, epoch: int = 0, **kwargs):
        raise _a16("export")

    def infer_shape(self, *args):
        return


class SymbolBlock(HybridBlock):
    """Runs an exported graph in JAX; waits for the port's export (A16)."""

    def __init__(self, *args, **kwargs):
        raise _a16("SymbolBlock")

    @staticmethod
    def imports(symbol_file, input_names=None, param_file=None, device=None,
                ctx=None):
        raise _a16("SymbolBlock.imports")


def functional_call(block: Block, pvals: Dict[str, Any], *args,
                    training: bool = False, rng_key=None):
    """Run ``block.forward`` with the parameters named in `pvals`
    (``collect_params`` names -> tensors) in place of their values.
    Returns ``(out, aux)``: `aux` holds the new values of ``grad_req=
    "null"`` parameters the call updated (BatchNorm's running
    statistics), which `pvals`' own tensors keep unchanged.  `rng_key`
    (an int) seeds the dropout draws of the call."""
    import contextlib
    params = block.collect_params()
    swapped, aux_src = [], {}
    for name, val in pvals.items():
        p = params[name]
        if p.grad_req == "null":
            val = aux_src.setdefault(name, (val, val.clone()))[1]
        swapped.append((p, p._data))
        p._data = val
        p._sync_owners()
    scope = _ag.train_mode() if training else _ag.predict_mode()
    rng = _rng.generator_scope(rng_key) if rng_key is not None else \
        contextlib.nullcontext()
    try:
        with scope, rng:
            out = block.forward(*args)
    finally:
        for p, old in reversed(swapped):
            p._data = old
            p._sync_owners()
    aux = {n: new for n, (old, new) in aux_src.items()
           if not torch.equal(old, new)}
    return out, aux
