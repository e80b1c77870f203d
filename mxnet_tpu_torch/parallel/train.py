"""The training step on one card (counterpart of
``mxnet_tpu/parallel/train.py`` ``ShardedTrainStep`` at dp=1).

`TrainStep` runs forward, ``loss_fn`` and backward through torch autograd,
then the optimizer's rule over every parameter
(`ops.fused_optimizer.apply_updates`), and leaves the new values in the
model's parameters (no second copy of the weights).  What it keeps from
the JAX step:

- the optimizer's route is resolved once, at construction
  (``_fused_opt_kernel``, from `ops.fused_optimizer.kernel_route` on the
  step's device under ``MXTPU_PALLAS``): the multi-tensor kernels update
  weights and state in place; the per-leaf reference route returns new
  values, copied into the parameters.  Changing ``MXTPU_PALLAS`` later
  never changes a live step.  ``update=`` replaces that route with a
  whole-tree update of `ops.fused_optimizer.kernel_plain`'s signature: an
  oracle passes `kernel_plain` itself, the kernels' math leaf by leaf
  with no launch;
- ``loss_fn(out, *batch)`` sees the whole batch; the first
  ``num_model_args`` arguments feed the model;
- optimizer state in f32 for 16-bit weights, with no f32 master copy of
  the weights (``_master_dtype``);
- the rules JAX's step cannot run are refused by name at construction
  (`_refusal`): SGLD and Nadam (not fused-safe: host random draws or a
  host-side running product at every call of the rule) and DCASGD (its
  state holds the previous weight, which JAX's donated step refuses).
  The gluon `Trainer` runs all three, per parameter;
- the learning rate is ``optimizer.learning_rate``, read at the
  optimizer's ``num_update``, which the step does not advance (nor does
  JAX's): an ``lr_scheduler`` is read at the count the caller sets;
- ``grad_accum=k`` splits every batch argument on its leading dim and
  averages the k gradients (mean of means) at ``grad_accum_dtype``;
- `warmup` builds the kernels and runs one forward and backward without
  touching the weights, the optimizer state or the dropout generators;
- `dispatch` returns a `StepHandle` whose ``loss`` stays on the device
  (no host sync); `steps_in_flight` counts steps the card has not
  finished.

A parameter the loss does not reach gets a zero gradient, as under
``jax.grad``.  Health probes and the non-finite skip guard stay off, as
the JAX default has them; they come with the operations-plane slice
(ROADMAP.md).
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import kernels
from ..base import MXNetError
from ..models.layers import Dropout
from ..ops.fused_optimizer import (HpScalarCache, apply_updates,
                                   kernel_route, supported)
from ..optimizer import DCASGD

__all__ = ["TrainStep", "StepHandle", "make_train_step"]


def _master_dtype(w: torch.Tensor) -> torch.dtype:
    """Optimizer state of a 16-bit float weight accumulates in f32."""
    if w.is_floating_point() and w.element_size() < 4:
        return torch.float32
    return w.dtype


class StepHandle:
    """Result of `TrainStep.dispatch`: ``loss`` is the f32 device scalar
    (not yet fetched), ``step`` the 1-based step index, ``dispatch_s`` the
    host time the dispatch took.  `result` blocks and returns the float;
    `is_ready` polls."""

    __slots__ = ("loss", "step", "dispatch_s", "_done")

    def __init__(self, loss, step: int, dispatch_s: float, done=None):
        self.loss = loss
        self.step = step
        self.dispatch_s = dispatch_s
        self._done = done

    def is_ready(self) -> bool:
        return self._done is None or self._done.query()

    def result(self) -> float:
        return float(self.loss)

    def __repr__(self):
        return (f"StepHandle(step={self.step}, "
                f"dispatch_ms={self.dispatch_s * 1e3:.3f})")


def _refusal(optimizer) -> Optional[str]:
    """Why `TrainStep` cannot run `optimizer` (None when it can): the rules
    JAX's jitted step fails on."""
    name = type(optimizer).__name__
    if not supported(optimizer):
        return (f"{name} is not fused-safe: its rule draws host random "
                f"numbers or advances host-side state at every call, "
                f"which one whole-tree step cannot carry (JAX's jitted "
                f"step traces it once)")
    if isinstance(optimizer, DCASGD):
        return (f"{name} keeps the previous weight as its state, which "
                f"JAX's step (donating its weights) refuses")
    return None


class TrainStep:
    """One training step of `model` with `optimizer` on the model's
    device: ``loss_fn(out, *batch) -> scalar tensor`` where ``out =
    model(*batch[:num_model_args])`` (all of the batch when None)."""

    def __init__(self, model: torch.nn.Module, optimizer, loss_fn: Callable,
                 num_model_args: Optional[int] = None, grad_accum: int = 1,
                 grad_accum_dtype=torch.float32,
                 update: Optional[Callable] = None):
        if grad_accum < 1:
            raise MXNetError(f"grad_accum must be >= 1, got {grad_accum}")
        why = _refusal(optimizer)
        if why:
            raise MXNetError(f"TrainStep: {why}; train it through "
                             f"gluon.Trainer, which updates it per "
                             f"parameter")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.num_model_args = num_model_args
        self.grad_accum = int(grad_accum)
        self.grad_accum_dtype = grad_accum_dtype
        params = dict(model.named_parameters())
        if not params:
            raise MXNetError("model has no parameters")
        self.params = params
        self.param_names = sorted(params)
        self.diff_names = [n for n in self.param_names
                           if params[n].requires_grad]
        self.device = params[self.param_names[0]].device
        self.opt_state = {
            n: optimizer.create_state(params[n].detach(),
                                      dtype=_master_dtype(params[n]))
            for n in self.diff_names}
        # the optimizer route, captured once (as the JAX step bakes it into
        # its traced program)
        self._update = update
        self._fused_opt_kernel = update is None and \
            kernel_route(optimizer, self.device)
        self._t = 0
        self._hp = HpScalarCache(self.device)
        self._inflight = collections.deque()
        self.compile_seconds = None

    # -- batch and hyperparameters -------------------------------------------
    def _prepare_batch(self, batch):
        out = []
        for b in batch:
            if isinstance(b, np.ndarray):
                b = torch.from_numpy(np.ascontiguousarray(b))
            out.append(torch.as_tensor(b, device=self.device))
        return tuple(out)

    # -- forward and backward -------------------------------------------------
    def _loss_and_grads(self, batch):
        n_model = self.num_model_args
        out = self.model(*(batch if n_model is None else batch[:n_model]))
        loss = self.loss_fn(out, *batch)
        diff = [self.params[n] for n in self.diff_names]
        grads = torch.autograd.grad(loss, diff, allow_unused=True)
        return loss.detach(), {
            n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(self.diff_names, diff, grads)}

    def _compute(self, batch):
        """(loss, grads) of one step, over `grad_accum` microbatches."""
        self.model.train()
        k = self.grad_accum
        if k == 1:
            return self._loss_and_grads(batch)
        for b in batch:
            if b.dim() < 1 or b.shape[0] % k:
                raise MXNetError(
                    f"grad_accum={k} must divide every batch arg's leading "
                    f"dim; got shape {tuple(b.shape)}")
        micro = [b.reshape((k, b.shape[0] // k) + tuple(b.shape[1:]))
                 for b in batch]
        dt = self.grad_accum_dtype
        acc = {n: torch.zeros(self.params[n].shape, dtype=dt,
                              device=self.device) for n in self.diff_names}
        lsum = torch.zeros((), dtype=dt, device=self.device)
        for i in range(k):
            loss, grads = self._loss_and_grads(tuple(m[i] for m in micro))
            for n in self.diff_names:
                acc[n] += grads[n].to(dt)
            lsum = lsum + loss
        grads = {n: (acc[n] / k).to(self.params[n].dtype)
                 for n in self.diff_names}
        return (lsum / k).to(torch.float32), grads

    def _generators(self):
        gens = {id(m.generator): m.generator for m in self.model.modules()
                if isinstance(m, Dropout) and m.generator is not None}
        return list(gens.values())

    # -- public API -------------------------------------------------------------
    def warmup(self, *batch) -> float:
        """Build the kernels (on the card) and run one forward and backward
        of `batch` without touching weights, optimizer state, the step
        count or the dropout generators.  Returns the seconds it took
        (also kept as `compile_seconds`)."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            kernels.build_all()
        batch = self._prepare_batch(batch)
        gens = self._generators()
        states = [g.get_state() for g in gens]
        try:
            self._compute(batch)
        finally:
            for g, s in zip(gens, states):
                g.set_state(s)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.compile_seconds = time.perf_counter() - t0
        return self.compile_seconds

    def dispatch(self, *batch) -> StepHandle:
        """Enqueue forward, backward and update; returns a `StepHandle`
        whose ``loss`` is still on the device."""
        t0 = time.perf_counter()
        batch = self._prepare_batch(batch)
        loss, grads = self._compute(batch)
        self._t += 1
        hp = self._hp.get(self.optimizer, self._t)
        live = {n: self.params[n].detach() for n in self.diff_names}
        if self._update is not None:
            new_p, self.opt_state = self._update(
                self.optimizer, live, grads, self.opt_state, hp)
        else:
            new_p, self.opt_state = apply_updates(
                self.optimizer, live, grads, self.opt_state, hp,
                use_kernel=self._fused_opt_kernel)
        with torch.no_grad():
            for n in self.diff_names:
                if new_p[n] is not live[n]:    # the kernels update in place
                    live[n].copy_(new_p[n])
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        dt = time.perf_counter() - t0
        self._inflight.append(done)
        return StepHandle(loss, self._t, dt, done)

    def steps_in_flight(self) -> int:
        """Dispatched steps the card has not finished (non-blocking)."""
        q = self._inflight
        while q and (q[0] is None or q[0].query()):
            q.popleft()
        return len(q)

    def __call__(self, *batch):
        """Run one step; returns the loss as an f32 device scalar."""
        return self.dispatch(*batch).loss


def make_train_step(model, optimizer, loss_fn, num_model_args=None,
                    grad_accum=1) -> TrainStep:
    return TrainStep(model, optimizer, loss_fn,
                     num_model_args=num_model_args, grad_accum=grad_accum)
