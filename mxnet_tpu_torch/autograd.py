"""Autograd public API (counterpart of ``mxnet_tpu/autograd.py``) over
torch's autograd.

Two flags, as in MXNet: *recording* and *training*, each thread-local.
`record` turns torch's grad mode on for its scope and `pause` turns it off
(outside any scope torch's own grad mode holds); the training flag is the
one `gluon.nn.Dropout` and `gluon.nn.BatchNorm` read, and a Gluon `Block`
sets its plain `torch.nn.Module` children's ``.training`` from it, so
dropout is on only inside ``record()`` (or ``train_mode()``), as in JAX.

`backward` and `grad` map onto ``torch.autograd.backward`` / ``grad``;
`Function` onto ``torch.autograd.Function``.  A variable's gradient lands
in its ``.grad`` (a Gluon `Parameter`'s in ``p.grad()``), written afresh by
each backward under ``grad_req="write"`` and summed under ``"add"``
(`mark_variables`, `gluon.Parameter`).
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = [
    "record", "pause", "train_mode", "predict_mode", "is_recording",
    "is_training", "set_recording", "set_training", "mark_variables",
    "backward", "grad", "Function",
]

_state = threading.local()


def is_recording() -> bool:
    return getattr(_state, "recording", False)


def is_training() -> bool:
    return getattr(_state, "training", False)


def set_recording(flag: bool) -> bool:
    """Set the recording flag (and torch's grad mode with it); returns the
    previous flag."""
    prev = is_recording()
    _state.recording = bool(flag)
    torch.set_grad_enabled(bool(flag))
    return prev


def set_training(flag: bool) -> bool:
    """Set the training flag; returns the previous one."""
    prev = is_training()
    _state.training = bool(flag)
    return prev


class _Scope:
    def __init__(self, recording, training):
        self._rec, self._train = recording, training
        self._prev = None

    def __enter__(self):
        self._prev = (is_recording(), is_training(),
                      torch.is_grad_enabled())
        if self._rec is not None:
            _state.recording = self._rec
            torch.set_grad_enabled(self._rec)
        if self._train is not None:
            _state.training = self._train
        return self

    def __exit__(self, *exc):
        _state.recording, _state.training, grad_on = self._prev
        torch.set_grad_enabled(grad_on)
        return False


def record(train_mode: bool = True):
    """Scope that records operations for `backward` (training mode by
    default)."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False):
    """Scope that stops recording (prediction mode by default)."""
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def _tensor(v):
    """The tensor behind a variable (a Gluon `Parameter`, an ``mx.np``
    array or a tensor)."""
    if _is_array(v):
        return v._data
    return v.data() if hasattr(v, "data") and callable(v.data) else v


def _is_array(v) -> bool:
    from .ndarray.ndarray import ndarray
    return isinstance(v, ndarray)


class _WriteHook:
    """Make each backward write a leaf's ``.grad`` afresh (MXNet's
    ``"write"``): the gradient of one backward pass reaches the leaf's hook
    once, summed, and the old ``.grad`` is dropped before torch would add
    to it.  Holds the leaf weakly; a pickled copy is inert."""

    def __init__(self, t=None):
        self._t = None if t is None else weakref.ref(t)

    def __call__(self, g):
        t = None if self._t is None else self._t()
        if t is not None:
            t.grad = None
        return g

    def __reduce__(self):
        return (_WriteHook, ())


def set_grad_req(t: torch.Tensor, req: str) -> None:
    """Give leaf `t` MXNet's `req` ("write", "add" or "null")."""
    if req not in ("write", "add", "null"):
        raise MXNetError(f"invalid grad_req {req!r}")
    handle = getattr(t, "_mx_write_hook", None)
    if handle is not None:
        handle.remove()
        t._mx_write_hook = None
    t.requires_grad_(req != "null")
    if req == "null":
        t.grad = None
    elif req == "write":
        t._mx_write_hook = t.register_hook(_WriteHook(t))
    t._mx_grad_req = req


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark tensors as variables: each starts with `gradients`' buffer as
    its ``.grad`` and takes the gradient request in `grad_reqs`."""
    if torch.is_tensor(variables) or _is_array(variables):
        variables, gradients = [variables], [gradients]
    variables = [_tensor(v) for v in variables]
    gradients = [_tensor(g) for g in gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, r in zip(variables, gradients, grad_reqs):
        set_grad_req(v, r)
        if r != "null":
            v.grad = g


def _head_grads(heads, head_grads):
    if head_grads is None:
        return [torch.ones_like(h) for h in heads]
    return [torch.ones_like(h) if g is None else
            torch.as_tensor(g, device=h.device).to(h.dtype)
            for h, g in zip(heads, head_grads)]


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of `heads` into the ``.grad`` of every variable they
    depend on (a non-scalar head takes a gradient of ones).  Heads may be
    ``mx.np`` arrays; an array that was not recorded adds nothing, as in
    the JAX package."""
    if torch.is_tensor(heads) or _is_array(heads):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    if any(_is_array(h) for h in heads):
        keep = [i for i, h in enumerate(heads)
                if not _is_array(h) or h._data.requires_grad]
        heads = [_tensor(heads[i]) for i in keep]
        if head_grads is not None:
            head_grads = [_tensor(head_grads[i]) for i in keep]
        if not heads:
            return
    elif isinstance(head_grads, (list, tuple)):
        head_grads = [_tensor(g) for g in head_grads]
    torch.autograd.backward(list(heads), _head_grads(heads, head_grads),
                            retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of `heads` with respect to `variables` (tensors or Gluon
    `Parameter`s), returned and not written to ``.grad``.
    ``create_graph=True`` records them for a higher-order gradient."""
    single = not isinstance(variables, (list, tuple))
    if torch.is_tensor(heads) or _is_array(heads):
        heads = [heads]
    arrays = any(_is_array(v) for v in ([variables] if single
                                        else variables))
    heads = [_tensor(h) for h in heads]
    if isinstance(head_grads, (list, tuple)):
        head_grads = [_tensor(g) for g in head_grads]
    vs = [_tensor(v) for v in ([variables] if single else variables)]
    if retain_graph is None:
        retain_graph = create_graph
    try:
        out = torch.autograd.grad(list(heads), vs,
                                  _head_grads(heads, head_grads),
                                  retain_graph=retain_graph,
                                  create_graph=create_graph)
    except RuntimeError as e:
        raise MXNetError(f"grad: {e}") from e
    if arrays:
        from .ndarray.ndarray import wrap
        out = [wrap(g) for g in out]
    return out[0] if single else list(out)


class _Bridge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fobj, *inputs):
        ctx.fobj = fobj
        with torch.no_grad():
            out = fobj.forward(*inputs)
        ctx.multi = isinstance(out, (tuple, list))
        return tuple(out) if ctx.multi else out

    @staticmethod
    def backward(ctx, *grads):
        with torch.no_grad():
            g = ctx.fobj.backward(*grads)
        if not isinstance(g, (tuple, list)):
            g = (g,)
        return (None,) + tuple(g)


class Function:
    """Custom differentiable function (MXNet's ``autograd.Function``):
    subclass, implement ``forward(self, *inputs)`` and ``backward(self,
    *output_grads)`` (one gradient an input), and call the instance."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        return _Bridge.apply(self, *inputs)
