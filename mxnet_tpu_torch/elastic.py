"""Elastic training / fault tolerance (counterpart of
``mxnet_tpu/elastic.py``: the same names, status dicts, events and
checkpoint layout).

The reference has no recovery story: a dead ps-lite server or worker kills
the whole job.  On a card the failure model is simpler to cover:

* **preemption** — a scheduler sends SIGTERM with a grace window; the
  right response is save-and-exit, then the scheduler restarts the job
  and it resumes from the newest checkpoint.
* **transient runtime errors** — surface as ``RuntimeError`` /
  ``MXNetError`` at the sync point (CUDA's asynchronous launches defer
  errors).  Recovery is restore-from-checkpoint and retry.
* **hangs** — a stuck collective never raises.  A watchdog thread detects
  a step that stopped completing, dumps all-thread stacks, and
  (optionally) kills the process so the supervisor can restart it.

`ElasticLoop` composes these around any step callable and any checkpoint
target exposing ``save(path)``/``load(path)`` (canonically
`parallel.TrainStep`, via `utils.CheckpointManager`).  The mesh
reformation (``mesh_controller=``, A12) and the data pipeline and device
prefetcher (``pipeline=``, ``prefetcher=``, A13) are not ported: passing
one raises `MXNetError` naming its ROADMAP.md item.

Usage::

    step = make_train_step(model, opt, loss_fn)
    loop = ElasticLoop(step, directory="/ckpts", save_every=500)
    loop.run(lambda i: step(*batch(i)), total_steps=10_000)
"""
from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Callable, Optional, Sequence

from . import health as _health
from . import recovery as _recovery
from . import telemetry as _tele
from .base import MXNetError, SuspectedHostLoss
from .resilience import fault_point
from .utils.checkpoint import CheckpointManager

__all__ = ["PreemptionGuard", "Watchdog", "FailureInjector", "ElasticLoop",
           "sync_flag", "sync_flags"]

_log = logging.getLogger(__name__)


class PreemptionGuard:
    """Convert termination signals into a cooperative stop flag, with a
    grace-deadline emergency-checkpoint path.

    Installs handlers for `signals` (default SIGTERM — what a preempting
    scheduler delivers) that set :attr:`preempted` instead of killing the
    process, giving the training loop a grace window to checkpoint. Restores
    the previous handlers on exit. Signal handlers only work on the main
    thread; elsewhere the guard degrades to a manual flag
    (:meth:`request_stop`).

    `grace` (default ``MXTPU_PREEMPT_GRACE``) is the seconds between the
    signal and the scheduler's SIGKILL; when set, the signal arms a
    deadline and :meth:`emergency_checkpoint` budgets its work against it:
    cancel the prefetcher, drain in-flight steps (bounded), run a
    deadline-bounded save, and — when even that cannot fit — fall back to
    a partial-state resume marker naming the newest complete checkpoint,
    so the restart resumes from durable state instead of whatever a
    truncated write left behind.  With no grace configured the emergency
    path degrades to the classic unbounded save-and-exit.

    `manager`: a `CheckpointManager` whose in-flight async save the
    guard's exit path waits out (:meth:`__exit__` calls ``wait_async()``)
    — a background checkpoint write must never be truncated by process
    teardown racing the writer thread.
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,),
                 grace: Optional[float] = None, manager=None):
        self._signals = tuple(signals)
        self._prev = {}
        self._event = threading.Event()
        self._installed = False
        self.grace = _recovery.preempt_grace() if grace is None else grace
        self.manager = manager
        self._deadline: Optional[float] = None

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def request_stop(self) -> None:
        """Manually trigger the stop flag (tests, custom schedulers).
        Arms the grace deadline exactly like the signal path."""
        self._arm()

    def _arm(self) -> None:
        if self.grace and self._deadline is None:
            self._deadline = time.monotonic() + self.grace
        self._event.set()

    def _handler(self, signum, frame):
        _log.warning("received signal %d: requesting checkpoint-and-exit"
                     "%s", signum,
                     f" (grace {self.grace:g}s)" if self.grace else "")
        self._arm()

    def deadline_remaining(self) -> Optional[float]:
        """Seconds left in the grace window; None when no grace is
        configured or no signal has arrived yet (unbounded)."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def emergency_checkpoint(self, manager=None, target=None,
                             step: int = 0, prefetcher=None,
                             drain_fraction: float = 0.5) -> dict:
        """Best-possible durable state inside the grace window.
        `manager` defaults to the guard's own (the one whose async saves
        `__exit__` waits out) — passing a different one would drain one
        manager while saving through another.

        1. cancel the prefetcher when one is passed (buffered batches
           are lost by design — they will be re-read on resume),
        2. drain in-flight dispatched steps, bounded to `drain_fraction`
           of the remaining deadline (``target.drain(timeout=...)`` when
           the target supports it),
        3. wait out any background async save (never truncate one),
        4. run ``manager.save`` on a worker thread with the remaining
           deadline; on timeout or error, fall back to a partial-state
           marker naming the newest *complete* checkpoint on disk,
        5. write the resumable marker `ElasticLoop.run` honors on
           restart.

        Returns ``{"step", "checkpoint", "complete", "partial"}``.
        """
        if manager is None:
            manager = self.manager
        if manager is None or target is None:
            raise MXNetError("emergency_checkpoint needs a manager "
                             "(constructor or argument) and a target")
        t0 = time.monotonic()
        fault_point("preempt_save")
        info = {"step": int(step), "checkpoint": None,
                "complete": False, "partial": False}
        if prefetcher is not None:
            try:
                prefetcher.close()
            except Exception:
                _log.exception("preemption: prefetcher cancel failed")
        remaining = self.deadline_remaining()
        drain = getattr(target, "drain", None)
        if callable(drain):
            try:
                left = drain(None if remaining is None
                             else max(0.1, remaining * drain_fraction))
                if left:
                    _log.warning("preemption: %d step(s) still in flight "
                                 "at the drain deadline", left)
            except Exception:
                _log.exception("preemption: in-flight drain failed")
        try:
            manager.wait_async()
        except Exception as e:
            _log.warning("preemption: deferred async save failed (%s); "
                         "the newest complete checkpoint stands", e)
        remaining = self.deadline_remaining()
        if remaining is None:
            # no grace window: the classic unbounded save-and-exit — a
            # failure here propagates (pre-deadline behavior), so a
            # supervisor never mistakes a failed save for a clean preempt
            info["checkpoint"] = manager.save(target, step)
            info["complete"] = True
        else:
            done: dict = {}

            def _save():
                try:
                    done["path"] = manager.save(target, step)
                except BaseException as e:
                    done["error"] = e

            t = threading.Thread(target=_save, daemon=True,
                                 name="mxtpu-preempt-save")
            t.start()
            t.join(max(0.1, remaining))
            if "path" in done:
                info["checkpoint"] = done["path"]
                info["complete"] = True
            else:
                # deadline too tight (or the write failed): fall back to
                # a partial-state manifest — the marker records the
                # newest COMPLETE checkpoint so the restart restores
                # durable state, and never a half-written file (the
                # atomic tmp+rename means the aborted save left no
                # visible checkpoint at all)
                info["partial"] = True
                newest = manager.latest()
                if newest is not None:
                    info["step"], info["checkpoint"] = newest
                else:
                    info["step"] = None
                _log.error(
                    "preemption: emergency save did not complete inside "
                    "the %.1fs grace remainder (%s); resume marker points "
                    "at the newest complete checkpoint (step %s)",
                    remaining,
                    done.get("error", "still writing"), info["step"])
        _tele.counter(
            "recovery_preempt_saves_total",
            "Emergency preemption checkpoints attempted",
            labelnames=("outcome",)).inc(
                outcome="complete" if info["complete"] else "partial")
        _tele.event("remediation", step=info["step"], kind="preempt_save",
                    complete=info["complete"], partial=info["partial"],
                    checkpoint=info["checkpoint"],
                    elapsed_s=round(time.monotonic() - t0, 3))
        _recovery.write_resume_marker(manager.directory, info)
        return info

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handler)
            self._installed = True
        return self

    def __exit__(self, *exc):
        if self._installed:
            for s, h in self._prev.items():
                signal.signal(s, h)
            self._prev.clear()
            self._installed = False
        if self.manager is not None:
            # a background save_async must finish before teardown can
            # truncate it; errors were/will be surfaced by the manager's
            # own drain paths — here completion is what matters
            try:
                self.manager.wait_async()
            except Exception as e:
                _log.warning("preemption guard: deferred async save "
                             "failed during exit (%s)", e)
        return False


class Watchdog:
    """Loop-level hang detector: fires if :meth:`ping` is not called
    within `timeout` seconds.

    A thin shim over `health.HangWatchdog`, scoped to
    the shared ``elastic_step`` heartbeat — detection, stall
    accounting (``health_stalls_total``, ``stall`` journal events,
    one flight-recorder bundle per hang episode), stack dumps, and
    stall suppression during kernel builds all live in ONE place.
    ``MXTPU_STALL_TIMEOUT`` (or `health.enable(stall_timeout_s=...)`)
    arms the process-wide watchdog over every hot path; this class
    keeps the loop-scoped ``on_hang``/``kill`` contract.

    On expiry the underlying watchdog dumps every thread's stack to
    stderr, records the stall, and this shim invokes `on_hang` and —
    when `kill=True` — SIGABRTs the process so a supervisor can restart
    it. The default is detect-and-report only.
    """

    def __init__(self, timeout: float, on_hang: Optional[Callable] = None,
                 kill: bool = False):
        if timeout <= 0:
            raise MXNetError("watchdog timeout must be positive")
        self.timeout = timeout
        self.on_hang = on_hang
        self.kill = kill
        self.fired = False
        self._wd: Optional[_health.HangWatchdog] = None

    def ping(self) -> None:
        # the shared heartbeat IS the liveness state: the shim's private
        # HangWatchdog watches only this name, and a fresh beat both
        # resets its clock and starts a new bundle episode
        _health.beat("elastic_step")

    def _on_stall(self, info: dict) -> None:
        self.fired = True
        if self.on_hang is not None:
            try:
                self.on_hang()
            except Exception:
                _log.exception("watchdog on_hang callback failed")
        if self.kill:
            os.kill(os.getpid(), signal.SIGABRT)

    def __enter__(self):
        self.ping()
        self._wd = _health.HangWatchdog(
            self.timeout, action="record", on_stall=self._on_stall,
            names=("elastic_step",), source="elastic_watchdog").start()
        return self

    def __exit__(self, *exc):
        if self._wd is not None:
            self._wd.stop()
            self._wd = None
        return False


class FailureInjector:
    """Deterministic fault injection: raises `exc_type` the first time
    each step in `at_steps` is reached.

    Kept for programmatic use; the env-driven registry in `resilience`
    (``MXTPU_FAULT_SPEC=elastic_step@N,...``) generalizes this to named
    points across the framework (checkpoint write/read, rollback
    restore, preemption save) and crosses process boundaries."""

    def __init__(self, at_steps: Sequence[int],
                 exc_type=RuntimeError):
        self._pending = set(at_steps)
        self._exc_type = exc_type
        self.injected = []

    def check(self, step: int) -> None:
        if step in self._pending:
            self._pending.discard(step)
            self.injected.append(step)
            raise self._exc_type(f"injected failure at step {step}")


# sync_flag's collective retry budget: a collective that fails 3 times over
# ~1s of backoff is a down peer, not a blip
_SYNC_RETRIES = 2
_SYNC_BASE_DELAY = 0.25


def sync_flag(flag: bool) -> bool:
    """Agree on a boolean across all processes (logical OR), so e.g. a
    preemption notice on one process checkpoints every process at the
    same step.  Without an initialised `torch.distributed` group of more
    than one process: identity.

    Failure mode (multi-process): a transient collective error is retried
    with backoff (`resilience.retry_with_backoff`); once the budget is
    exhausted the processes can no longer agree on a common step, so this
    raises `MXNetError` — the right response is to let the job die and
    resume every process from the newest checkpoint rather than
    checkpoint a diverged state."""
    return sync_flags(flag)[0]


def sync_flags(*flags: bool, timeout: Optional[float] = None) -> tuple:
    """OR-reduce several booleans across all processes in ONE collective
    (``all_reduce`` with ``MAX`` over an int32 tensor; same retry policy
    and failure semantics as `sync_flag`).  The recovery-enabled loop
    syncs its preemption, exit and rollback decisions per iteration —
    packing them keeps that at a single round-trip.

    The collective is **timeout-bounded** (default
    ``MXTPU_ELASTIC_SYNC_TIMEOUT``, 120 s; 0 disables): a peer that died
    before entering the round surfaces as `SuspectedHostLoss` instead of
    stalling every surviving process."""
    group = _recovery._process_group()
    if group is None:
        return tuple(bool(f) for f in flags)

    def _gather():
        import torch
        import torch.distributed as dist
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend(group) == "nccl" else torch.device("cpu")
        v = torch.tensor([1 if f else 0 for f in flags], dtype=torch.int32,
                         device=dev)
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=group)
        return tuple(bool(x) for x in v.tolist())

    if timeout is None:
        timeout = _recovery.sync_timeout()
    try:
        # each retry attempt runs on its own bounded worker thread
        # (recovery.coordinated_round): a dead peer never ANSWERS the
        # collective, so the bound has to come from outside it
        return _recovery.coordinated_round(
            _gather, timeout=timeout, name="mxtpu-flag-sync",
            retries=_SYNC_RETRIES, base_delay=_SYNC_BASE_DELAY,
            timeout_msg=
            f"elastic.sync_flags: multi-process flag sync did not "
            f"complete within {timeout or 0:g}s — a peer is suspected "
            f"lost; restart the job and resume from the newest "
            f"checkpoint")
    except (RuntimeError, OSError) as e:
        if isinstance(e, SuspectedHostLoss):
            raise
        raise MXNetError(
            f"elastic.sync_flag: multi-process all_reduce failed after "
            f"{_SYNC_RETRIES} retries ({e}); processes cannot agree on a "
            f"common step — restart the job and resume from the newest "
            f"checkpoint") from e


class ElasticLoop:
    """Checkpointed, preemption-aware, self-restoring training loop.

    Composes `CheckpointManager` (periodic atomic saves + resume),
    `PreemptionGuard` (SIGTERM → save-and-exit), `Watchdog` (hang report)
    and restore-retry on transient step failures around a user step
    function ``step_fn(i) -> loss``. Restores go through the manager's
    verified fallback chain: a corrupt latest checkpoint is quarantined
    and the rollback lands on the newest intact one, so bit-rot costs one
    (deeper) rollback instead of failing every restore-retry.

    The `target` must expose ``save(path)``/``load(path)``. Returns a dict
    with the exit status — ``"completed"``, ``"preempted"`` (checkpoint
    written; rerun to resume), ``"aborted"`` (the recovery policy's
    tier-3 exit: rollback budget exhausted, crash bundle flushed) — or
    raises after `max_restores` failed recoveries.

    **Self-healing** (``MXTPU_RECOVERY`` / `recovery`): a
    `recovery.RecoveryPolicy` subscribed to the health monitor turns
    anomalies into remediation the loop executes between steps — on-device
    non-finite skips (tier 1, accounted by the policy), rollback to the
    newest healthy-tagged checkpoint with the poison window fast-forwarded
    (tier 2, through the `data_skip` hook when one is given; with a
    `torch.distributed` group the restore step is agreed via
    `recovery.agree_step` so every process restores the same step or none
    do), and a clean budgeted stop (tier 3).  `recovery=None` auto-builds
    the default policy when the env var is set; pass ``recovery=False``
    to opt out explicitly.

    `data_reset` (optional) is called after every restore with the
    resumed step: rebuild whatever feeds the loop.  `pipeline`,
    `prefetcher` (A13) and `mesh_controller` (A12) are not ported and
    raise `MXNetError`.
    """

    def __init__(self, target, directory: str, save_every: int = 100,
                 keep: int = 3, max_restores: int = 3,
                 watchdog_timeout: Optional[float] = None,
                 retry_on=(RuntimeError, MXNetError),
                 failure_injector: Optional[FailureInjector] = None,
                 async_save: bool = False,
                 recovery=None, prefetcher=None,
                 preempt_grace: Optional[float] = None,
                 data_skip: Optional[Callable[[int], None]] = None,
                 mesh_controller=None, pipeline=None,
                 data_reset: Optional[Callable[[int], object]] = None):
        if mesh_controller is not None:
            raise MXNetError(
                "ElasticLoop(mesh_controller=...): elastic mesh "
                "reformation (parallel.elastic_mesh) is not ported yet "
                "(ROADMAP.md A12)")
        for name, val in (("pipeline", pipeline),
                          ("prefetcher", prefetcher)):
            if val is not None:
                raise MXNetError(
                    f"ElasticLoop({name}=...): the data pipeline and the "
                    f"device prefetcher are not ported yet (ROADMAP.md "
                    f"A13)")
        self.target = target
        self.manager = CheckpointManager(directory, keep=keep)
        self.save_every = save_every
        self.max_restores = max_restores
        # MXTPU_STALL_TIMEOUT arms the loop-level watchdog too, so one
        # env var covers both the per-step and process-wide detectors
        if watchdog_timeout is None:
            watchdog_timeout = _health.stall_timeout()
        self.watchdog_timeout = watchdog_timeout
        self.retry_on = tuple(retry_on)
        self.failure_injector = failure_injector
        # periodic saves overlap training (TrainStep.save_async);
        # preemption/rollback/final saves stay synchronous — those must
        # be on disk before the process acts on them
        self.async_save = async_save
        if recovery is None and _recovery.enabled():
            recovery = _recovery.RecoveryPolicy()
        self.recovery = recovery or None   # False -> None
        self.preempt_grace = preempt_grace
        self.data_reset = data_reset
        self.data_skip = data_skip
        # step ids (1-based, = the monitor's/journal's step-id space) the
        # post-rollback replay fast-forwards over.  The spaces stay
        # aligned across rollbacks because the dispatch counter is
        # checkpointed state: `TrainStep.load` resets `_t` to the
        # restored step exactly when the loop resets `i` to it.
        self._replay_skip: set = set()

    _deferred_failures = 0

    def _reset_data(self, step: int) -> None:
        """After a restore landed on `step`: let the owner rebuild whatever
        feeds the loop."""
        if self.data_reset is None:
            return
        try:
            self.data_reset(step)
        except Exception:
            _log.exception("elastic: data_reset hook failed at step %d "
                           "(continuing with the current data path)", step)

    def _drain_async_tolerant(self):
        """Surface-but-survive a deferred async-write failure: the loop's
        recovery/preemption/final paths must not let an OLD write error
        mask the operation they're about to perform (the last COMPLETE
        checkpoint on disk is still valid).  CONSECUTIVE failures are
        bounded like step failures — a full disk must not let the job
        run for days producing no durable checkpoints."""
        try:
            self.manager.wait_async()
            self._deferred_failures = 0
        except Exception as e:   # noqa: BLE001 — deliberately broad
            self._deferred_failures += 1
            if self._deferred_failures > self.max_restores:
                raise MXNetError(
                    f"elastic: {self._deferred_failures} consecutive async "
                    f"checkpoint writes failed; aborting rather than "
                    f"training without durable checkpoints") from e
            _log.warning(
                "elastic: a deferred async checkpoint write failed (%s); "
                "continuing from the last complete checkpoint "
                "(%d/%d consecutive)", e, self._deferred_failures,
                self.max_restores)

    def _maybe_periodic_save(self, i: int) -> None:
        """Periodic checkpoint when one is due at step `i`.  Drains only
        then: draining every step would cap write/compute overlap at one
        step."""
        if self.save_every > 0 and i % self.save_every == 0:
            self._drain_async_tolerant()
            self.manager.maybe_save(self.target, i, every=self.save_every,
                                    async_save=self.async_save)

    def _resume_start(self) -> int:
        """Initial restore, honoring a preemption resume marker when one
        is present: a marker naming a complete emergency checkpoint pins
        the resume to exactly that step (the marker is cleared either
        way — it describes one preemption, not a standing instruction)."""
        marker = _recovery.read_resume_marker(self.manager.directory)
        if marker is not None:
            _recovery.clear_resume_marker(self.manager.directory)
            step = marker.get("step")
            if marker.get("complete") and step is not None:
                try:
                    start = self.manager.restore(self.target,
                                                 step=int(step))
                    _tele.event("remediation", step=start,
                                kind="preempt_resume",
                                checkpoint=marker.get("checkpoint"))
                    _log.info("elastic: resumed from emergency "
                              "preemption checkpoint at step %d", start)
                    return start
                except Exception as e:
                    _log.warning(
                        "elastic: resume marker points at step %s but the "
                        "restore failed (%s); falling back to the "
                        "checkpoint chain", step, e)
            else:
                _log.warning(
                    "elastic: preemption left a partial-state marker "
                    "(grace window too tight for a full save); resuming "
                    "from the newest complete checkpoint")
        return self.manager.restore(self.target)

    def _perform_rollback(self, action: dict, current: int,
                          restores: int) -> int:
        """Tier-2 remediation: restore the newest healthy-tagged
        checkpoint (agreed across processes when there are several) and
        arm the
        poison-window fast-forward.  Returns the step to resume from."""
        reason = action.get("reason", "?")
        _log.warning("elastic: recovery rollback requested at step %d "
                     "(%s)", current, reason)
        # drain in-flight dispatched steps first: their retirements feed
        # the monitor, and a restore under steps still running on the
        # card would race their in-place updates
        drain = getattr(self.target, "drain", None)
        if callable(drain):
            try:
                drain(timeout=60.0)
            except Exception:
                _log.exception("elastic: in-flight drain before rollback "
                               "failed")
        self._drain_async_tolerant()
        multi = _recovery._process_group() is not None
        if multi:
            cand = self.manager.newest_healthy()
            agreed = _recovery.agree_step(cand[0] if cand is not None
                                          else 0)
            if agreed == 0:
                # some host has NO healthy-tagged candidate (margin can
                # disqualify every retained checkpoint after a long
                # divergence).  Mirror the single-host fallback — a
                # suspect restore beats resetting a long run to the
                # step-0 anchor — by agreeing on the newest checkpoint
                # regardless of tag.  Same collective program order on
                # every host: all of them observed agreed == 0.
                newest = self.manager.latest()
                agreed = _recovery.agree_step(
                    newest[0] if newest is not None else 0)
                _log.error(
                    "elastic: no cluster-wide healthy rollback "
                    "candidate; agreed on newest checkpoint step %d "
                    "regardless of health tag", agreed)
            fault_point("rollback_restore")
            # all hosts restore the agreed step or none do: an explicit
            # restore raises on corruption (or on a missing agreed
            # checkpoint) instead of silently falling back to a step the
            # peers did not agree on; the raise kills the job and every
            # host restarts from its verified chain
            restored = self.manager.restore(self.target, step=agreed)
        else:
            fault_point("rollback_restore")
            restored = self.manager.restore(self.target,
                                            healthy_only=True)
        poison = []
        if self.recovery is not None:
            self.recovery.note_rollback(restored)
            poison = self.recovery.consume_poison(restored)
        self._replay_skip.update(poison)
        # checkpoints newer than the restore point belong to the
        # abandoned (diverged) timeline: a crash before the next periodic
        # save must not resume INTO the state we just rolled away from
        discarded = self.manager.discard_newer(restored)
        _tele.event("remediation", step=restored, tier=action.get("tier", 2),
                    kind="rollback", reason=reason, from_step=current,
                    restored_step=restored, poison=poison[:32],
                    discarded=discarded[:32], restores=restores)
        _log.warning(
            "elastic: rolled back from step %d to healthy checkpoint at "
            "step %d (%s); fast-forwarding %d poison step(s)%s",
            current, restored, reason, len(poison),
            f", discarded {len(discarded)} newer checkpoint(s)"
            if discarded else "")
        self._reset_data(restored)
        return restored

    def run(self, step_fn: Callable[[int], object], total_steps: int,
            on_step: Optional[Callable[[int, object], None]] = None) -> dict:
        restores = 0       # total, reported in the result
        consecutive = 0    # failed recoveries in a row, bounds the retry
        rollbacks = 0      # policy-driven (tier-2) rollbacks
        start = self._resume_start()
        self._reset_data(start)
        if start:
            _log.info("elastic: resumed from checkpoint at step %d", start)
        elif self.manager.latest() is None:
            # anchor checkpoint so a failure before the first periodic save
            # still has a consistent state to roll back to
            self.manager.save(self.target, 0)
        guard = PreemptionGuard(grace=self.preempt_grace,
                                manager=self.manager)
        watchdog = (Watchdog(self.watchdog_timeout)
                    if self.watchdog_timeout else None)
        if self.recovery is not None:
            self.recovery.attach()
        last_loss = None
        i = start
        try:
            with guard:
                ctx = watchdog if watchdog is not None else _null_ctx()
                with ctx:
                    while i < total_steps:
                        # remediation decisions are process-local
                        # (anomalies retire on local timing, budget
                        # windows are local wall-clock), so with several
                        # processes ALL of them — preemption, tier-3
                        # exit, tier-2 rollback — are OR-reduced in one
                        # packed collective before anyone acts: a process
                        # entering agree_step (or returning) while a peer
                        # sits in this iteration's flag sync would
                        # mismatch collective order.  A dead peer surfaces
                        # as the bounded round's SuspectedHostLoss, which
                        # propagates (no mesh reformation, A12)
                        action = (self.recovery.poll()
                                  if self.recovery is not None else None)
                        want_exit = (action is not None
                                     and action["kind"] == "exit")
                        want_rb = (action is not None
                                   and action["kind"] == "rollback")
                        preempted, want_exit, want_rb = sync_flags(
                            guard.preempted, want_exit, want_rb)
                        if preempted:
                            self._drain_async_tolerant()
                            info = guard.emergency_checkpoint(
                                target=self.target, step=i)
                            _log.warning(
                                "elastic: preempted at step %d; %s "
                                "checkpoint %s written", i,
                                "emergency" if info["complete"]
                                else "PARTIAL (marker only)",
                                info.get("checkpoint"))
                            return {"status": "preempted", "step": i,
                                    "checkpoint": info.get("checkpoint"),
                                    "restores": restores,
                                    "emergency": info}
                        if want_exit:
                            if action is None or action["kind"] != "exit":
                                action = {"kind": "exit",
                                          "reason": "peer_request",
                                          "tier": 3, "step": i}
                            return self._tier3_exit(action, i, restores)
                        if want_rb:
                            if action is None \
                                    or action["kind"] != "rollback":
                                action = {"kind": "rollback",
                                          "reason": "peer_request",
                                          "tier": 2, "step": i}
                            restores += 1
                            rollbacks += 1
                            i = self._perform_rollback(action, i, restores)
                            continue
                        if self._replay_skip and (i + 1) in \
                                self._replay_skip:
                            # fast-forward the poison window: this
                            # attempt's data fed an anomaly on the
                            # abandoned timeline — skip it rather than
                            # re-train on it (index-based sources skip
                            # the index; stream sources drop one batch
                            # via the data_skip hook)
                            self._replay_skip.discard(i + 1)
                            if self.data_skip is not None:
                                try:
                                    self.data_skip(i + 1)
                                except Exception:
                                    _log.exception(
                                        "elastic: data_skip hook failed")
                            _tele.event("remediation", step=i + 1,
                                        tier=2, kind="data_skip")
                            _log.warning("elastic: skipping poison step "
                                         "%d after rollback", i + 1)
                            i += 1
                            # a skipped step still honors a due periodic
                            # save (the state — restored + clean replays —
                            # is valid; silently missing the boundary
                            # would double the next failure's rollback
                            # distance).  on_step is NOT called: no step
                            # ran, and reporting a phantom loss would be
                            # worse than a gap in the step indices.
                            self._maybe_periodic_save(i)
                            continue
                        try:
                            # env-driven injection (MXTPU_FAULT_SPEC
                            # elastic_step@N — Nth step ATTEMPT, replays
                            # included, so a recovered run replays clean);
                            # generalizes the programmatic FailureInjector
                            fault_point("elastic_step")
                            if self.failure_injector is not None:
                                self.failure_injector.check(i)
                            last_loss = step_fn(i)
                            # a completed step proves the recovery worked;
                            # max_restores bounds CONSECUTIVE failed
                            # recoveries, not total hiccups over a long
                            # job's lifetime
                            consecutive = 0
                        except self.retry_on as e:
                            restores += 1
                            consecutive += 1
                            if consecutive > self.max_restores:
                                raise MXNetError(
                                    f"elastic: step {i} failed after "
                                    f"{self.max_restores} restores") from e
                            self._drain_async_tolerant()
                            rollback = self.manager.restore(self.target)
                            self._reset_data(rollback)
                            _log.warning(
                                "elastic: step %d failed (%s); restored "
                                "checkpoint at step %d (restore %d/%d)",
                                i, e, rollback, consecutive,
                                self.max_restores)
                            i = rollback
                            continue
                        i += 1
                        if watchdog is not None:
                            watchdog.ping()
                        if on_step is not None:
                            on_step(i, last_loss)
                        self._maybe_periodic_save(i)
        finally:
            if self.recovery is not None:
                self.recovery.detach()
        self._drain_async_tolerant()
        final = self.manager.save(self.target, total_steps)
        return {"status": "completed", "step": total_steps,
                "checkpoint": final, "restores": restores,
                "rollbacks": rollbacks, "loss": last_loss,
                "reforms": 0}

    def _tier3_exit(self, action: dict, step: int, restores: int) -> dict:
        """Tier-3 remediation: the rollback budget is exhausted — flush a
        post-mortem bundle and stop cleanly rather than burn the
        reservation on a rollback loop."""
        reason = action.get("reason", "rollback_budget_exhausted")
        self._drain_async_tolerant()
        bundle = _health.dump_bundle(f"recovery_exit:{reason}")
        _tele.counter(
            "recovery_exits_total",
            "Tier-3 clean stops (rollback budget exhausted)").inc()
        _tele.event("remediation", step=step, tier=3, kind="exit",
                    reason=reason, bundle=bundle)
        _log.error(
            "elastic: recovery policy requested a tier-3 exit at step %d "
            "(%s); post-mortem bundle: %s", step, reason, bundle)
        return {"status": "aborted", "step": step, "reason": reason,
                "restores": restores, "bundle": bundle}


class _null_ctx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
