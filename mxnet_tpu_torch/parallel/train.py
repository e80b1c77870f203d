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
  finished and retires the rest, `drain` waits for them;
- the operations plane, as JAX's step has it:
  - **probes** (`health` enabled when the step is built,
    ``MXTPU_HEALTH``): the gradients' global L2 norm and their count of
    non-finite elements, both f32 device scalars computed between the
    backward pass and the update (plain torch reductions, as XLA fuses
    JAX's outside any kernel), returned on the `StepHandle` and handed to
    `health.HealthMonitor` when the step retires — read from pinned host
    memory the step copied them to asynchronously, so retiring never
    syncs;
  - **the non-finite skip** (`recovery` enabled too, ``MXTPU_RECOVERY``):
    ``skip = nonfinite > 0 or the loss is not finite``, a device bool
    passed to `apply_updates(skip=)`: the chunk or LAMB kernels (the
    per-leaf ``torch.where`` on the reference route) keep every weight
    and state bit-exactly, with no host sync between the backward pass
    and the update;
  - telemetry events and tracing spans under JAX's names
    (``step_dispatched``, ``step_retired``, ``compile_start`` /
    ``compile_end`` around `warmup`; ``train.dispatch``,
    ``train.device``, ``train.compile``), health beats at dispatch and
    retire, and the step's FLOPs counted once at `warmup` when telemetry
    is on (`tracing.FlopCount`; `cost_features`, `mfu_estimate`);
  - `save`, `save_async` and `load` in JAX's ``.npz`` layout: ``p:<name>``
    for every parameter, ``s:<name>:<i>`` for every state tensor,
    ``meta:t`` and ``meta:rng_seed`` (bf16 arrays as their uint16 bits
    under a ``__bf16__`` tag), plus ``meta:torch_generator:<i>``: the
    state of each dropout generator, which JAX's keyed PRNG cannot share
    (JAX's ``meta:rng_key`` is ignored on load);
  with health off at construction the step launches nothing for them.
  The plane's serving side (SLO alerts, QoS, the traffic journal) and the
  remat policies JAX selects by ``checkpoint_name`` wait for ROADMAP.md
  A14 part 2.

A parameter the loss does not reach gets a zero gradient, as under
``jax.grad``.
"""
from __future__ import annotations

import collections
import concurrent.futures as _cf
import logging
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import autograd as _ag
from .. import health as _health
from .. import kernels
from .. import profiler as _profiler
from .. import recovery as _recovery
from .. import telemetry as _tele
from .. import tracing as _trace
from ..base import MXNetError
from ..gluon.nn import Dropout
from ..ndarray.ndarray import ndarray as _ndarray, wrap as _wrap
from ..ops.fused_optimizer import (HpScalarCache, apply_updates,
                                   kernel_route, supported)
from ..optimizer import DCASGD

__all__ = ["TrainStep", "StepHandle", "make_train_step"]

_log = logging.getLogger(__name__)
_GEN_KEY = "meta:torch_generator:"


def _master_dtype(w: torch.Tensor) -> torch.dtype:
    """Optimizer state of a 16-bit float weight accumulates in f32."""
    if w.is_floating_point() and w.element_size() < 4:
        return torch.float32
    return w.dtype


class StepHandle:
    """Result of `TrainStep.dispatch`: ``loss`` is the f32 device scalar
    (not yet fetched), ``step`` the 1-based step index, ``dispatch_s`` the
    host time the dispatch took, ``probes`` the f32 device scalars
    ``{"grad_norm", "nonfinite"}`` when health probes are on (else None).
    `result` blocks and returns the float; `is_ready` polls."""

    __slots__ = ("loss", "step", "dispatch_s", "probes", "_done")

    def __init__(self, loss, step: int, dispatch_s: float, done=None,
                 probes=None):
        self.loss = loss
        self.step = step
        self.dispatch_s = dispatch_s
        self.probes = probes
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
        # (step id, loss, probes, host probe copy, dispatch time, device
        # span, done event) per dispatched step not yet retired
        self._inflight = collections.deque(maxlen=256)
        self.compile_seconds = None
        # the operations plane, captured once (as JAX traces it into its
        # step): with health off here the step launches nothing for it
        self._health_probes = _health.probes_enabled()
        self._skip_nonfinite = (self._health_probes
                                and _recovery.skip_enabled())
        self._cost_key = f"train_step@{id(self):x}"
        self._last_retire_t: Optional[float] = None
        self._ckpt_last = None
        _health.register_inflight_source(self)

    # -- batch and hyperparameters -------------------------------------------
    def _prepare_batch(self, batch):
        out = []
        for b in batch:
            if isinstance(b, _ndarray):
                b = b._data
            elif isinstance(b, np.ndarray):
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
        """(loss, grads) of one step, over `grad_accum` microbatches, in
        training mode (dropout on), as JAX's step runs its forward with
        ``training=True``: a Gluon block takes its mode from
        `autograd.is_training`, which is off outside ``record()``."""
        self.model.train()
        with _ag.train_mode():
            return self._compute_in_train_mode(batch)

    def _compute_in_train_mode(self, batch):
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

    def _probes(self, grads):
        """The gradients' global L2 norm and non-finite element count, f32
        device scalars (JAX's ``grad_norm`` / ``nonfinite``).  Per dtype
        group the leaves are flattened into one buffer: one norm and one
        count a group, whatever the number of leaves.  The count is exact
        (int64, then f32)."""
        groups = {}
        for n in self.diff_names:
            g = grads[n]
            groups.setdefault(g.dtype, []).append(g.reshape(-1))
        sq, bad = [], []
        for leaves in groups.values():
            flat = leaves[0] if len(leaves) == 1 else torch.cat(leaves)
            sq.append(torch.linalg.vector_norm(flat, dtype=torch.float32))
            bad.append(torch.isfinite(flat).logical_not_().sum())
        gnorm = sq[0] if len(sq) == 1 else \
            torch.linalg.vector_norm(torch.stack(sq))
        nonfinite = (bad[0] if len(bad) == 1 else
                     torch.stack(bad).sum()).to(torch.float32)
        return {"grad_norm": gnorm, "nonfinite": nonfinite}

    # -- public API -------------------------------------------------------------
    def warmup(self, *batch) -> float:
        """Build the kernels (on the card) and run one forward and backward
        of `batch` without touching weights, optimizer state, the step
        count or the dropout generators.  Returns the seconds it took
        (also kept as `compile_seconds`)."""
        if _tele.enabled():
            _tele.event("compile_start", step=self._t, kind="warmup")
        t0 = time.perf_counter()
        c_span = _trace.get_tracer("train").span(
            "train.compile", step=self._t, kind="warmup") \
            if _trace.enabled() else None
        count = _trace.FlopCount(self.device) if _tele.enabled() else None
        try:
            # minutes of nvcc are expected silence, not a hang
            with _health.suppress_stalls("kernel_build"):
                if self.device.type == "cuda":
                    kernels.build_all()
                batch = self._prepare_batch(batch)
                gens = self._generators()
                states = [g.get_state() for g in gens]
                try:
                    if count is not None:
                        with count:
                            self._compute(batch)
                    else:
                        self._compute(batch)
                finally:
                    for g, s in zip(gens, states):
                        g.set_state(s)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            if c_span is not None:
                c_span.__exit__(None, None, None)
        self.compile_seconds = time.perf_counter() - t0
        if count is not None:
            _trace.record_executable(
                self._cost_key, count, kind="train_step", source="warmup",
                dtype=str(self._main_dtype()).replace("torch.", ""),
                device=str(self.device))
        if _tele.enabled():
            _tele.event("compile_end", step=self._t, kind="warmup",
                        seconds=round(self.compile_seconds, 4))
        return self.compile_seconds

    def _main_dtype(self) -> torch.dtype:
        """The dtype most of the weights' elements have (the MFU's peak)."""
        sizes = {}
        for p in self.params.values():
            sizes[p.dtype] = sizes.get(p.dtype, 0) + p.numel()
        return max(sizes, key=sizes.get)

    # -- performance attribution (tracing) ---------------------------------
    def cost_features(self) -> Optional[dict]:
        """The step's counted cost features (``flops`` and their split),
        or None before a `warmup` under telemetry counted them."""
        return _trace.account().features(self._cost_key)

    def mfu_estimate(self, measured_step_s: float) -> Optional[dict]:
        """MFU of one step taking `measured_step_s` wall seconds, from the
        counted FLOPs and the card's peak for the weights' dtype."""
        return _trace.account().mfu(self._cost_key, measured_step_s)

    def dispatch(self, *batch) -> StepHandle:
        """Enqueue forward, backward and update; returns a `StepHandle`
        whose ``loss`` (and ``probes``) are still on the device."""
        _health.beat("train_step.dispatch")
        t0 = time.perf_counter()
        # manual span (not the thread-local stack): an exception mid-
        # dispatch must not strand an open span under later dispatches
        d_span = _trace.get_tracer("train").start_span(
            "train.dispatch", track="train host", step=self._t + 1) \
            if _trace.enabled() else None
        batch = self._prepare_batch(batch)
        self._t += 1
        with _profiler.step_annotation("mxtpu.train_step",
                                       step_num=self._t):
            loss, grads = self._compute(batch)
            probes = self._probes(grads) if self._health_probes else None
            skip = None
            if self._skip_nonfinite:
                # tier 1: a non-finite gradient (or loss) turns the whole
                # update into the identity, decided on the device
                skip = torch.logical_or(
                    probes["nonfinite"] > 0,
                    torch.isfinite(loss.to(torch.float32)).logical_not())
            hp = self._hp.get(self.optimizer, self._t)
            live = {n: self.params[n].detach() for n in self.diff_names}
            if self._update is not None:
                extra = {} if skip is None else {"skip": skip}
                new_p, self.opt_state = self._update(
                    self.optimizer, live, grads, self.opt_state, hp, **extra)
            else:
                new_p, self.opt_state = apply_updates(
                    self.optimizer, live, grads, self.opt_state, hp, skip,
                    use_kernel=self._fused_opt_kernel)
            with torch.no_grad():
                for n in self.diff_names:
                    if new_p[n] is not live[n]:  # the kernels update in place
                        live[n].copy_(new_p[n])
        host = None
        if probes is not None:
            # the values the monitor reads at retire, copied to pinned host
            # memory behind the step: retiring never syncs
            vals = torch.stack([loss.to(torch.float32), probes["grad_norm"],
                                probes["nonfinite"]])
            if self.device.type == "cuda":
                host = torch.empty(3, dtype=torch.float32, pin_memory=True)
                host.copy_(vals, non_blocking=True)
            else:
                host = vals
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        dt = time.perf_counter() - t0
        x_span = None
        if d_span is not None:
            x_span = _trace.get_tracer("train").start_span(
                "train.device", parent=d_span.context(),
                track="train device", step=self._t)
            d_span.finish(dispatch_ms=round(dt * 1e3, 3))
        self._inflight.append((self._t, loss, probes, host,
                               time.perf_counter(), x_span, done))
        if _tele.enabled():
            _tele.histogram(
                "step_dispatch_ms",
                "Host time per dispatch() call (not device step time; "
                "overlap works when this sits far below step time)"
            ).observe(dt * 1e3)
            _tele.event("step_dispatched", step=self._t,
                        dispatch_ms=round(dt * 1e3, 3))
            _tele.gauge(
                "steps_in_flight",
                "Dispatched steps whose loss has not landed on the host"
            ).set(self.steps_in_flight())
        elif self._health_probes:
            self.steps_in_flight()   # retire → feed the health monitor
        return StepHandle(loss, self._t, dt, done, probes)

    def steps_in_flight(self) -> int:
        """Dispatched steps the card has not finished (non-blocking).
        Finished ones retire: a health beat, the ``train.device`` span's
        end, the probes handed to the health monitor, a ``step_retired``
        event with the step's cost features and measured time."""
        q = self._inflight
        batch = []
        while q and (q[0][-1] is None or q[0][-1].query()):
            batch.append(q.popleft())
        if batch:
            now = time.perf_counter()
            # measured step wall: retire-to-retire cadence in a pipelined
            # steady state (the first retire falls back to dispatch ->
            # retire); steps retiring in the same poll share the interval
            prev, self._last_retire_t = self._last_retire_t, now
            base = prev if prev is not None else batch[0][4]
            measured_s = max(0.0, now - base) / len(batch)
            for step_id, _loss, probes, host, _t, x_span, _done in batch:
                _health.beat("train_step.retire")
                if x_span is not None:
                    x_span.finish(t1=now)
                if host is not None:
                    self._observe_health(step_id, host)
                if _tele.enabled():
                    cost = _trace.note_step_cost(
                        self._cost_key, measured_s) \
                        if measured_s > 0 else None
                    if cost is not None:
                        _tele.event("step_retired", step=step_id,
                                    cost=cost)
                    else:
                        _tele.event("step_retired", step=step_id)
        return len(q)

    def drain(self, timeout: Optional[float] = None) -> int:
        """Block until every dispatched step has retired, or the `timeout`
        deadline passes (polling, never a device sync); returns the steps
        still in flight.  The recovery paths call this before acting on
        training state."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.steps_in_flight():
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.0005)
        return len(self._inflight)

    @staticmethod
    def _observe_health(step_id, host) -> None:
        """Hand one retired step's loss and probes (host floats, read from
        the pinned copy the step made) to the health monitor."""
        mon = _health.monitor()
        if mon is None:
            return
        try:
            loss, gnorm, bad = (float(x) for x in host.tolist())
            mon.observe(step_id, loss=loss, grad_norm=gnorm,
                        nonfinite=int(bad))
        except Exception:   # monitoring must never take the step down
            _log.exception("health probe observation failed")

    # -- checkpoint / resume (JAX's `.npz` layout) ---------------------------
    def save(self, path: str) -> None:
        """Checkpoint weights, optimizer state, the step count, the seed and
        the dropout generators to `path` (.npz), atomically."""
        self._drain_async_save()
        self._write_checkpoint(path, self._snapshot())

    def save_async(self, path: str):
        """Non-blocking checkpoint: the training state is snapshotted now
        (on a card: asynchronous copies into pinned host memory, enqueued
        behind the steps already dispatched, so later in-place updates
        cannot reach them) and written by one background thread while
        training continues.  Returns a future; ``.result()`` waits and
        re-raises a writer error.  One async save at a time: a second call
        waits for the first."""
        self._drain_async_save()
        snap = self._snapshot(copy=True)
        fut = _ckpt_pool().submit(self._write_checkpoint, path, snap)
        self._ckpt_last = fut
        return fut

    def _drain_async_save(self):
        """Wait for the async save in flight, if any.  A writer error is
        left to whoever holds the future (`CheckpointManager` surfaces it);
        the next save must not fail for it."""
        fut, self._ckpt_last = self._ckpt_last, None
        if fut is not None:
            _cf.wait([fut])

    def _snapshot(self, copy: bool = False):
        """A consistent view of the training state; `copy` detaches it from
        the live tensors (see `save_async`)."""
        tensors = {"p:" + n: self.params[n].detach()
                   for n in self.param_names}
        for n in self.diff_names:
            for i, leaf in enumerate(self.opt_state[n]):
                tensors[f"s:{n}:{i}"] = leaf
        done = None
        if copy:
            if self.device.type == "cuda":
                out = {}
                for k, t in tensors.items():
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    out[k] = h
                tensors = out
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            else:
                tensors = {k: t.clone() for k, t in tensors.items()}
        from .. import random as _rng
        return {"tensors": tensors, "done": done, "t": self._t,
                "rng_seed": _rng._seed[0],
                "generators": [g.get_state() for g in self._generators()]}

    def _write_checkpoint(self, path: str, snap) -> str:
        from ..util import save_arrays
        done = snap["done"]
        while done is not None and not done.query():
            time.sleep(0.001)   # polled: a writer thread never syncs
        out = dict(snap["tensors"])
        out["meta:t"] = np.asarray(snap["t"], np.int64)
        out["meta:rng_seed"] = np.asarray(snap["rng_seed"], np.int64)
        for i, st in enumerate(snap["generators"]):
            out[f"{_GEN_KEY}{i}"] = st.numpy().copy()
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            save_arrays(tmp, out)
            os.replace(tmp, path)   # atomic: a crash never truncates it
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    def load(self, path: str) -> None:
        """Restore a `save` checkpoint (the port's or JAX's step's): every
        weight and state tensor in place (states at this step's dtype), the
        step count, the seed and, when the file has them, the dropout
        generators."""
        from .. import random as _rng
        from ..util import load_arrays
        self.drain()
        raw = load_arrays(path)
        for n in self.param_names:
            if "p:" + n not in raw:
                raise MXNetError(f"checkpoint {path} missing parameter {n}")
            src, p = raw["p:" + n], self.params[n]
            if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
                raise MXNetError(
                    f"checkpoint {path}: parameter {n} is {src.dtype} "
                    f"{tuple(src.shape)}, the model's {p.dtype} "
                    f"{tuple(p.shape)}")
        for n in self.diff_names:
            for i in range(len(self.opt_state[n])):
                if f"s:{n}:{i}" not in raw:
                    raise MXNetError(
                        f"checkpoint {path} missing optimizer state "
                        f"s:{n}:{i} (optimizer type changed since save?)")
        with torch.no_grad():
            for n in self.param_names:
                self.params[n].copy_(raw["p:" + n])
            for n in self.diff_names:
                for i, leaf in enumerate(self.opt_state[n]):
                    leaf.copy_(raw[f"s:{n}:{i}"].to(leaf.dtype))
        self._t = int(raw["meta:t"])
        if "meta:rng_seed" in raw:
            _rng._seed[0] = int(raw["meta:rng_seed"])
        gens = self._generators()
        states = [raw[k] for k in sorted(
            (k for k in raw if k.startswith(_GEN_KEY)),
            key=lambda k: int(k[len(_GEN_KEY):]))]
        if states and len(states) != len(gens):
            raise MXNetError(
                f"checkpoint {path} holds {len(states)} dropout generator "
                f"state(s), the model has {len(gens)}")
        for g, st in zip(gens, states):
            g.set_state(st.to(torch.uint8))

    def __call__(self, *batch):
        """Run one step; returns the loss as an f32 device scalar (an
        ``mx.np`` array when the batch came as arrays)."""
        loss = self.dispatch(*batch).loss
        if any(isinstance(b, _ndarray) for b in batch):
            return _wrap(loss)
        return loss


def make_train_step(model, optimizer, loss_fn, num_model_args=None,
                    grad_accum=1) -> TrainStep:
    return TrainStep(model, optimizer, loss_fn,
                     num_model_args=num_model_args, grad_accum=grad_accum)


_pool = None
_pool_lock = threading.Lock()


def _ckpt_pool():
    """The one background thread every `TrainStep.save_async` writes on."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = _cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mxtpu-ckpt")
        return _pool
