"""Gluon `Trainer` (counterpart of ``mxnet_tpu/gluon/trainer.py``).

The user's loop is the reference's: forward, ``loss.backward()``, then
``trainer.step(batch_size)``.  `step` scales the gradients by
``1 / batch_size`` (``rescale_grad``) and updates every parameter with one
whole-tree `ops.fused_optimizer.apply_updates` call (`_fused_update`): on
the kernel route (`kernel_route`, ``MXTPU_PALLAS``; the default on the
card) the multi-tensor CUDA kernels update weights and state in place —
one chunk launch per dtype group for the nine chunk rules (Adam, AdamW,
SGD, NAG, Signum, AdaBelief, Adamax, AdaDelta, FTML), for LAMB one
phase-A and one phase-B launch per dtype group — and on the reference
route (and for every other fused-safe rule: LARS, DCASGD, LANS and the
AdaGrad family) the per-leaf rule runs and its results are copied in.
The hyperparameters live on the device, uploaded again only when lr, wd,
rescale_grad or clip_gradient change; the step count ``t`` is filled each
step.  ``num_update`` advances before the rate is read, so with an
``lr_scheduler`` step k runs at ``lr_scheduler(k)``, as JAX's does.

Rules that are not fused-safe (SGLD, Nadam), per-name rate multipliers
(``lr_mult`` / ``wd_mult`` on the optimizer, or ``lr_mult`` /
``wd_mult`` attributes on a parameter) and ``multi_precision=True``
take the per-parameter route, `Optimizer.update_multi_precision` (JAX's
loop), never the chunk kernel.

The optimizer state is kept in each weight's dtype (bf16 moments for a
bf16 weight, JAX's ``multi_precision=False``); with
``multi_precision=True`` a 16-bit weight's state is an f32 master copy
and the rule's f32 state on it (`Optimizer.create_state_multi_precision`),
and the weight is the master rounded after each step.
`parallel.TrainStep` keeps f32 state.

AMP's dynamic loss scaler (`amp.init("float16")`, then
`amp.init_trainer(trainer)`): `step` first checks every gradient for inf
and NaN (`LossScaler.has_overflow`, one device reduction and one
readback) and updates the scale; an overflowed step changes no weight
and no state, and a clean one divides the scale it used back out through
``rescale_grad``, as JAX's `step` does.

Gradients: torch's ``backward`` accumulates where MXNet's
``grad_req="write"`` overwrites, so after each update the `Trainer` clears
(sets to None) the gradients of the parameters it updated, and the next
``backward`` writes them afresh; a Gluon parameter under ``"add"`` keeps
its sum until ``zero_grad``.  A parameter whose gradient is None (the
loss never reached it) is updated with a zero gradient, as JAX's
zero-initialised gradient buffer is; ``ignore_stale_grad`` is accepted and,
as in JAX, changes nothing.

Not ported yet (each raises `MXNetError`; ROADMAP.md lists them): a
kvstore (``kvstore`` other than None/False, ``update_on_kvstore``,
``compression_params``) and row-sparse (sparse-layout) gradients.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..base import MXNetError
from .. import optimizer as opt
from ..ops import fused_optimizer as _fopt
from ..optimizer.updater import Updater
from .parameter import Parameter as GluonParameter

__all__ = ["Trainer"]


def _unported(what: str) -> MXNetError:
    return MXNetError(f"Trainer: {what} is not ported yet (see ROADMAP.md, "
                      f"queue A, items 7 and 12)")


def _to_device(state, device):
    """A state (tensors, nested in tuples) on `device`."""
    if torch.is_tensor(state):
        return state.to(device)
    return tuple(_to_device(s, device) for s in state)


class Trainer:
    """``Trainer(params, optimizer, optimizer_params)``: `params` is a dict
    of name -> Gluon `Parameter` (``net.collect_params()``) or name ->
    ``torch.nn.Parameter`` (``dict(model.named_parameters())``), or a list
    of either (keys "0", "1", ...); the names key the optimizer state.
    Parameters with ``grad_req="null"`` (``requires_grad=False``) are not
    updated; ``"add"`` ones keep their summed gradients across steps
    until ``zero_grad``.  A parameter's ``lr_mult`` / ``wd_mult`` scale its
    rate and decay (the per-parameter route), as MXNet's `Trainer` passes
    its parameters to the optimizer.  `optimizer` is a registered name or
    an `Optimizer`."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore=None, compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            param_dict = dict(params)
        elif isinstance(params, (list, tuple)):
            param_dict = {str(i): p for i, p in enumerate(params)}
        else:
            raise MXNetError("params must be a dict or a list of Parameter")
        reqs = {}
        for k, p in param_dict.items():
            if isinstance(p, GluonParameter):
                reqs[k] = p.grad_req
            elif isinstance(p, torch.nn.Parameter):
                reqs[k] = "write" if p.requires_grad else "null"
            else:
                raise MXNetError(f"expected a Parameter, got {type(p)}")
        if kvstore not in (None, False):
            raise _unported(f"kvstore={kvstore!r}")
        if update_on_kvstore:
            raise _unported("update_on_kvstore")
        if compression_params:
            raise _unported("gradient compression (compression_params)")
        self._param_dict = param_dict
        self._param_names: List[str] = [k for k, r in reqs.items()
                                        if r != "null"]
        self._keep_grads = {k for k, r in reqs.items() if r == "add"}
        self._optimizer = opt.create(optimizer, param_idx2name={
            i: n for i, n in enumerate(self._param_names)},
            **(optimizer_params or {}))
        if not self._optimizer.param_dict:
            # the rate multipliers come from the parameters themselves
            self._optimizer.param_dict = {
                n: param_dict[n] for n in self._param_names}
        self._states: Dict[str, tuple] = {}
        self._scale = 1.0
        self._hp_cache = None

    @property
    def _params(self) -> List[torch.Tensor]:
        """The tensors of the updated parameters (a Gluon parameter's
        value is made at its first forward when its shape is deferred)."""
        return [p.data() if isinstance(p, GluonParameter) else p
                for p in (self._param_dict[n] for n in self._param_names)]

    @property
    def _device(self) -> torch.device:
        devs = {p.device for p in self._params}
        if len(devs) > 1:
            raise MXNetError(f"Trainer: parameters on several devices "
                             f"{sorted(map(str, devs))}")
        return devs.pop() if devs else torch.device("cpu")

    @property
    def _hp(self):
        if self._hp_cache is None:
            self._hp_cache = _fopt.HpScalarCache(self._device)
        return self._hp_cache

    def _drop_grads(self, params):
        """Clear the gradients of the updated parameters (``"add"`` ones
        keep theirs until ``zero_grad``)."""
        for n, p in zip(self._param_names, params):
            if n not in self._keep_grads:
                p.grad = None

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
                self._states[n] = \
                    self._optimizer.create_state_multi_precision(n, p)

    def _check_unported(self):
        for n, p in zip(self._param_names, self._params):
            if p.grad is not None and p.grad.layout != torch.strided:
                raise _unported(f"a sparse gradient (parameter {n})")

    def step(self, batch_size, ignore_stale_grad=False):
        """Gradient reduction (none without a kvstore), then one optimizer
        update with ``rescale_grad = 1 / batch_size``.

        With AMP's scaler attached (`amp.init_trainer`) the gradients are
        checked for inf and NaN first: an overflowed step is skipped whole
        -- no weight or state changes -- and the scale shrinks; a clean
        step divides out the scale its loss was multiplied by.  Either
        way the gradients are then dropped, as after every step (MXNet's
        next backward overwrites them; torch's would add to them)."""
        self._check_unported()
        scaler = getattr(self, "_amp_loss_scaler", None)
        divisor = 1.0
        if scaler is not None and scaler.active:
            divisor = scaler.loss_scale      # the scale this loss used
            overflow = scaler.has_overflow(self._params)
            scaler.update_scale(overflow)
            if overflow:
                self._drop_grads(self._params)
                return
        self._optimizer.rescale_grad = self._scale / batch_size / divisor
        try:
            self.allreduce_grads()
            self.update(batch_size, ignore_stale_grad=ignore_stale_grad,
                        _already_reduced=True)
        finally:
            self._optimizer.rescale_grad = self._scale / batch_size

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
        params = self._params
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in zip(self._param_names, params)}
        if getattr(self._optimizer, "fused_safe", True) and \
                not self._optimizer.multi_precision and \
                self._uniform_mults():
            self._fused_update(grads)
        else:
            for n, p in zip(self._param_names, params):
                self._states[n] = self._optimizer.update_multi_precision(
                    n, p.detach(), grads[n], self._states[n])
        self._drop_grads(params)

    def _uniform_mults(self) -> bool:
        o = self._optimizer
        if o.lr_mult or o.wd_mult:
            return False
        return all(getattr(p, "lr_mult", 1.0) == 1.0 and
                   getattr(p, "wd_mult", 1.0) == 1.0
                   for p in o.param_dict.values())

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
        self._states = {n: _to_device(st, params[n].device)
                        for n, st in u.states.items()}
        if u.optimizer is not self._optimizer:
            self._optimizer.num_update = u.optimizer.num_update
            self._optimizer._index_update_count = \
                dict(u.optimizer._index_update_count)
