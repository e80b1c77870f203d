"""Gluon `Trainer` (counterpart of ``mxnet_tpu/gluon/trainer.py``).

The user's loop is the reference's: forward, ``loss.backward()``, then
``trainer.step(batch_size)``.  `step` scales the gradients by
``1 / batch_size`` (``rescale_grad``) and updates every parameter with one
whole-tree `ops.fused_optimizer.apply_updates` call (`_fused_update`): on
the kernel route (`kernel_route`, ``MXTPU_PALLAS``; the default on the
card) the multi-tensor CUDA kernels update weights and state in place —
one chunk launch per dtype group for Adam, AdamW and SGD, LAMB's two
phases per tensor — and on the reference route the per-leaf rule runs and
its results are copied in.  The hyperparameters live on the device,
uploaded again only when lr, wd, rescale_grad or clip_gradient change; the
step count ``t`` is filled each step.

Rules that are not fused-safe, and per-name rate multipliers (``lr_mult``
/ ``wd_mult`` on the optimizer, or ``lr_mult`` / ``wd_mult`` attributes on
a parameter), take the per-leaf route, `Optimizer.update`.

The optimizer state is kept in each weight's dtype (bf16 moments for a
bf16 weight, JAX's ``multi_precision=False``); `parallel.TrainStep` keeps
f32 state instead.

Gradients: torch's ``backward`` accumulates where MXNet's
``grad_req="write"`` overwrites, so after each update the `Trainer` clears
(sets to None) the gradients of the parameters it updated, and the next
``backward`` writes them afresh.  A parameter whose gradient is None (the
loss never reached it) is updated with a zero gradient, as JAX's
zero-initialised gradient buffer is; ``ignore_stale_grad`` is accepted and,
as in JAX, changes nothing.

Not ported yet (each raises `MXNetError`; ROADMAP.md lists them): a
kvstore (``kvstore`` other than None/False, ``update_on_kvstore``,
``compression_params``), ``multi_precision=True``, AMP's loss scaler and
row-sparse (sparse-layout) gradients.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..base import MXNetError
from .. import optimizer as opt
from ..ops import fused_optimizer as _fopt
from ..optimizer.updater import Updater

__all__ = ["Trainer"]


def _unported(what: str) -> MXNetError:
    return MXNetError(f"Trainer: {what} is not ported yet (see ROADMAP.md, "
                      f"queue A, items 7 and 12)")


class Trainer:
    """``Trainer(params, optimizer, optimizer_params)``: `params` is a dict
    of name -> `torch.nn.Parameter` (``dict(model.named_parameters())``;
    the names key the optimizer state) or a list (keys "0", "1", ...);
    parameters with ``requires_grad=False`` are not updated (MXNet's
    ``grad_req="null"``).  `optimizer` is a registered name or an
    `Optimizer`."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore=None, compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            param_dict = dict(params)
        elif isinstance(params, (list, tuple)):
            param_dict = {str(i): p for i, p in enumerate(params)}
        else:
            raise MXNetError("params must be a dict or a list of Parameter")
        for p in param_dict.values():
            if not isinstance(p, torch.nn.Parameter):
                raise MXNetError(f"expected torch.nn.Parameter, got "
                                 f"{type(p)}")
        if kvstore not in (None, False):
            raise _unported(f"kvstore={kvstore!r}")
        if update_on_kvstore:
            raise _unported("update_on_kvstore")
        if compression_params:
            raise _unported("gradient compression (compression_params)")
        self._param_dict = param_dict
        self._param_names: List[str] = [k for k, p in param_dict.items()
                                        if p.requires_grad]
        self._params = [param_dict[k] for k in self._param_names]
        devs = {p.device for p in self._params}
        if len(devs) > 1:
            raise MXNetError(f"Trainer: parameters on several devices "
                             f"{sorted(map(str, devs))}")
        self._device = devs.pop() if devs else torch.device("cpu")
        self._optimizer = opt.create(optimizer, param_idx2name={
            i: n for i, n in enumerate(self._param_names)},
            **(optimizer_params or {}))
        if self._optimizer.multi_precision:
            raise _unported("multi_precision=True (an f32 master copy)")
        self._states: Dict[str, tuple] = {}
        self._scale = 1.0
        self._hp = _fopt.HpScalarCache(self._device)

    # -- properties ----------------------------------------------------------
    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # -- main API -------------------------------------------------------------
    def _ensure_states(self):
        for n, p in zip(self._param_names, self._params):
            if n not in self._states:
                self._states[n] = tuple(self._optimizer.create_state(
                    p.detach(), dtype=p.dtype))

    def _check_unported(self):
        if getattr(self, "_amp_loss_scaler", None) is not None:
            raise _unported("AMP's loss scaler")
        for n, p in zip(self._param_names, self._params):
            if p.grad is not None and p.grad.layout != torch.strided:
                raise _unported(f"a sparse gradient (parameter {n})")

    def step(self, batch_size, ignore_stale_grad=False):
        """Gradient reduction (none without a kvstore), then one optimizer
        update with ``rescale_grad = 1 / batch_size``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad=ignore_stale_grad,
                    _already_reduced=True)

    def allreduce_grads(self):
        """A no-op: there is no kvstore (one card)."""
        return None

    def update(self, batch_size, ignore_stale_grad=False,
               _already_reduced=False):
        """The optimizer update alone (after `allreduce_grads`)."""
        self._check_unported()
        if not _already_reduced:
            self._optimizer.rescale_grad = self._scale / batch_size
        self._ensure_states()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in zip(self._param_names, self._params)}
        if getattr(self._optimizer, "fused_safe", True) and \
                self._uniform_mults():
            self._fused_update(grads)
        else:
            for n, p in zip(self._param_names, self._params):
                self._optimizer.update(n, p.detach(), grads[n],
                                       self._states[n])
        for p in self._params:
            p.grad = None

    def _uniform_mults(self) -> bool:
        o = self._optimizer
        if o.lr_mult or o.wd_mult or o.param_dict:
            return False
        return all(getattr(p, "lr_mult", 1.0) == 1.0 and
                   getattr(p, "wd_mult", 1.0) == 1.0 for p in self._params)

    # -- the fused whole-tree update ------------------------------------------
    def _fused_update(self, grads):
        o = self._optimizer
        o.num_update += 1
        t = o.num_update
        names = self._param_names
        for n in names:
            o._index_update_count[n] = t
        live = {n: p.detach() for n, p in zip(names, self._params)}
        new_p, new_s = _fopt.apply_updates(
            o, live, {n: grads[n].detach() for n in names},
            {n: self._states[n] for n in names}, self._hp.get(o, t),
            use_kernel=_fopt.kernel_route(o, self._device))
        with torch.no_grad():
            for n in names:
                if new_p[n] is not live[n]:    # the kernels update in place
                    live[n].copy_(new_p[n])
        self._states.update(new_s)

    # -- checkpointing ---------------------------------------------------------
    def save_states(self, fname):
        """The optimizer state and step counts, to `fname`."""
        self._ensure_states()
        u = Updater(self._optimizer)
        u.states = dict(self._states)
        with open(fname, "wb") as f:
            f.write(u.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load `save_states`' file: the states go to the weights' device
        and dtype, and the saved step counts are adopted."""
        u = Updater(self._optimizer)
        with open(fname, "rb") as f:
            u.set_states(f.read())
        params = dict(zip(self._param_names, self._params))
        self._states = {
            n: tuple(s.to(params[n].device) for s in st)
            for n, st in u.states.items()}
        if u.optimizer is not self._optimizer:
            self._optimizer.num_update = u.optimizer.num_update
            self._optimizer._index_update_count = \
                dict(u.optimizer._index_update_count)
