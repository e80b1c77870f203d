"""Self-healing training: the anomaly→remediation policy engine
(counterpart of ``mxnet_tpu/recovery.py``: the same names, environment
variables, tiers, counters, event names and resume-marker format).

Detection drives automatic, budgeted remediation — an escalation ladder
instead of a recorded anomaly and a run that silently diverges or dies.

The ladder (:class:`RecoveryPolicy`, wired into `elastic.ElasticLoop` as
the default policy when ``MXTPU_RECOVERY`` is set):

* **Tier 1 — in-place skip.**  On ``nonfinite_grads``/``loss_nonfinite``
  the optimizer update for that step is dropped *on the device*
  (`parallel.TrainStep` computes a skip flag from its non-finite probe
  and the loss when recovery is enabled at its construction, and the
  optimizer kernels apply the identity — no host sync between the
  backward pass and the update).  Host-side, the policy accounts each
  skip, backs off the attached AMP `amp.LossScaler`, and escalates once
  more than ``MXTPU_SKIP_BUDGET`` steps were skipped inside the budget
  window — a stream of NaN batches is data corruption, not weather.

* **Tier 2 — rollback.**  Persistent divergence (``loss_spike`` /
  ``grad_explosion`` on N consecutive steps) drains the in-flight steps,
  restores the newest **healthy-tagged** checkpoint through the verified
  fallback chain (`CheckpointManager` manifests carry a health snapshot
  at save time; only checkpoints written in healthy windows are rollback
  candidates), fast-forwards the data past the poison window, and
  resumes.  With a `torch.distributed` process group the rollback step is
  agreed via a timeout-guarded min-reduce (:func:`agree_step`) so every
  process restores the same step — or none do.

* **Tier 3 — exit.**  After ``MXTPU_ROLLBACK_BUDGET`` rollbacks inside a
  window, the run flushes a crash flight-recorder bundle and stops
  cleanly: a job that keeps rolling back is broken.

Independently, preemption handling has a **grace-deadline emergency
checkpoint** path (`elastic.PreemptionGuard.emergency_checkpoint`): on
SIGTERM in-flight steps drain under a deadline, a deadline-bounded save
runs (falling back to a partial-state resume marker when the grace window
is too tight for a full write), and the process exits with a resumable
marker (:func:`write_resume_marker`) that ``ElasticLoop.run`` honors on
restart.

Everything here is stdlib-only at import time; the multi-process
consensus imports torch lazily.  Remediation is observable: every action
increments a ``recovery_*`` counter and records a ``remediation`` journal
event.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import List, Optional

from . import health as _health
from . import telemetry as _tele
from .resilience import fault_point, retry_with_backoff

__all__ = [
    "RecoveryPolicy", "enabled", "enable", "disable", "skip_enabled",
    "health_snapshot", "agree_step", "preempt_grace", "sync_timeout",
    "bounded_round", "coordinated_round",
    "write_resume_marker", "read_resume_marker", "clear_resume_marker",
    "ENV_ENABLE", "ENV_SKIP_BUDGET", "ENV_ROLLBACK_BUDGET",
    "ENV_PREEMPT_GRACE", "ENV_SYNC_TIMEOUT", "MARKER_NAME",
]

_log = logging.getLogger(__name__)

ENV_ENABLE = "MXTPU_RECOVERY"
ENV_SKIP_BUDGET = "MXTPU_SKIP_BUDGET"
ENV_ROLLBACK_BUDGET = "MXTPU_ROLLBACK_BUDGET"
ENV_PREEMPT_GRACE = "MXTPU_PREEMPT_GRACE"
ENV_SYNC_TIMEOUT = "MXTPU_ELASTIC_SYNC_TIMEOUT"

DEFAULT_SKIP_BUDGET = 8
DEFAULT_ROLLBACK_BUDGET = 2
#: bound on every multi-process coordination round (flag sync, step
#: consensus, membership) before a peer is declared suspect
DEFAULT_SYNC_TIMEOUT = 120.0

#: resumable marker a preemption leaves in the checkpoint directory;
#: ElasticLoop.run honors (and clears) it on the next start
MARKER_NAME = "preempt.resume.json"


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        _log.warning("ignoring non-integer %s=%r", name, raw)
        return default
    return val if val >= 0 else default


def preempt_grace() -> Optional[float]:
    """``MXTPU_PREEMPT_GRACE`` parsed to seconds, or None (unset/invalid/
    non-positive).  The grace window a preempting scheduler grants
    between SIGTERM and SIGKILL — the budget the emergency checkpoint must
    fit."""
    raw = os.environ.get(ENV_PREEMPT_GRACE, "").strip()
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        _log.warning("ignoring non-numeric %s=%r", ENV_PREEMPT_GRACE, raw)
        return None
    return val if val > 0 else None


def sync_timeout() -> Optional[float]:
    """``MXTPU_ELASTIC_SYNC_TIMEOUT`` parsed to seconds (default 120):
    the bound every multi-process coordination round — `elastic.sync_flags`
    and :func:`agree_step` — waits before raising `SuspectedHostLoss`
    instead of stalling forever on a dead peer.  ``0`` (or negative)
    disables the bound → None (unbounded)."""
    raw = os.environ.get(ENV_SYNC_TIMEOUT, "").strip()
    if not raw:
        return DEFAULT_SYNC_TIMEOUT
    try:
        val = float(raw)
    except ValueError:
        _log.warning("ignoring non-numeric %s=%r", ENV_SYNC_TIMEOUT, raw)
        return DEFAULT_SYNC_TIMEOUT
    return val if val > 0 else None


def bounded_round(fn, timeout: Optional[float], name: str,
                  timeout_msg: str):
    """Run one multi-process coordination round with a wall-clock bound:
    ``fn`` executes on a daemon worker thread and a round still running
    after ``timeout`` seconds raises `SuspectedHostLoss` with
    ``timeout_msg`` (``timeout=None`` → run inline, unbounded).  The one
    shared implementation behind `elastic.sync_flags` and
    :func:`agree_step`.

    A FRESH thread per round is deliberate: a dead peer never answers
    the collective, so after a timeout the stranded worker is still
    blocked inside it — a reused single-worker executor would queue
    every later round behind that corpse.  For the same reason ``fn``
    must be a SINGLE collective attempt, with any retry policy wrapped
    *around* this call: a stranded worker that kept issuing fresh
    retried collectives would race the survivor's next round and pair
    against the wrong collective on the peers.  Exceptions from ``fn``
    propagate unwrapped so each caller keeps its own error contract."""
    if timeout is None or timeout <= 0:   # 0 disables, as documented
        return fn()
    from .base import SuspectedHostLoss
    result: dict = {}

    def _run():
        try:
            result["value"] = fn()
        except BaseException as e:  # delivered to the caller below
            result["error"] = e

    t = threading.Thread(target=_run, daemon=True, name=name)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise SuspectedHostLoss(timeout_msg)
    if "error" in result:
        raise result["error"]
    return result["value"]


class _RoundTimeout(BaseException):
    """Internal carrier lifting a round timeout past retry_with_backoff
    (which never retries non-Exception BaseExceptions) — a suspected-dead
    peer must not strand one worker thread per retry attempt."""

    def __init__(self, cause):
        super().__init__(str(cause))
        self.cause = cause


def coordinated_round(attempt, *, timeout: Optional[float], name: str,
                      timeout_msg: str, retries: int = 2,
                      base_delay: float = 0.25):
    """One retried, timeout-bounded coordination round.  ``attempt`` is
    a SINGLE collective call: transient failures (RuntimeError/OSError)
    retry with backoff, each try on its own bounded worker thread
    (:func:`bounded_round`), while a timeout raises `SuspectedHostLoss`
    immediately — never retried, and the one stranded attempt issues no
    further collectives to race the survivor's next round."""
    def _once():
        try:
            return bounded_round(attempt, timeout, name, timeout_msg)
        except Exception as e:
            from .base import SuspectedHostLoss as _SHL
            if isinstance(e, _SHL):
                raise _RoundTimeout(e) from None
            raise

    try:
        return retry_with_backoff(_once, retries=retries,
                                  base_delay=base_delay,
                                  retry_on=(RuntimeError, OSError))
    except _RoundTimeout as t:
        raise t.cause


# ---------------------------------------------------------------------------
# module state: enable/disable + the healthy-window tracker
# ---------------------------------------------------------------------------

class _AnomalyTracker:
    """Minimal per-process record of 'when did the run last look sick',
    feeding the health snapshot stamped into checkpoint manifests.  Kept
    separate from `HealthMonitor`'s anomaly ring because the ring
    survives a rollback — an anomaly from the abandoned timeline must not
    make every post-rollback checkpoint look unhealthy, so the policy
    resets THIS tracker when a rollback lands."""

    def __init__(self):
        self._lock = threading.Lock()
        self.last_step: Optional[int] = None
        self.last_time: Optional[float] = None
        self.count = 0

    def note(self, row: dict) -> None:
        if skip_enabled() and row.get("rule") in ("nonfinite_grads",
                                                  "loss_nonfinite"):
            # the on-device tier-1 guard dropped this update: the training
            # state never took the hit, so a checkpoint written shortly
            # after is as healthy as the step before the bad batch —
            # counting it would disqualify perfectly good rollback
            # candidates every time a NaN batch is skipped
            with self._lock:
                self.count += 1
            return
        with self._lock:
            self.count += 1
            self.last_time = time.monotonic()
            step = row.get("step")
            if step is not None:
                if self.last_step is None or step > self.last_step:
                    self.last_step = int(step)

    def reset(self) -> None:
        with self._lock:
            self.last_step = None
            self.last_time = None

    def snapshot(self, step: Optional[int], margin: int) -> dict:
        with self._lock:
            healthy = True
            if self.last_step is not None:
                if step is None or step - self.last_step <= margin:
                    # covers the negative case too (save step below the
                    # last anomaly step = mid-divergence save)
                    healthy = False
            elif self.last_time is not None:
                # step-less anomalies (e.g. loss_scale_collapse before any
                # probe retired): recent wall-clock sickness counts
                healthy = time.monotonic() - self.last_time > 60.0
            return {"healthy": healthy, "anomaly_count": self.count,
                    "last_anomaly_step": self.last_step}


_tracker = _AnomalyTracker()
_enabled = False
_state_lock = threading.Lock()

#: steps of "no anomaly" required before a checkpoint is tagged healthy
HEALTHY_MARGIN = 16


def enabled() -> bool:
    return _enabled


def skip_enabled() -> bool:
    """Gate for the on-device skip-update guard.  `TrainStep` reads this
    once at construction (alongside `health.probes_enabled`): flipping
    recovery after construction needs a new step object, and with
    recovery off the step computes no skip flag."""
    return _enabled


def enable() -> None:
    """Turn the recovery subsystem on.  Implies `health.enable()` — the
    policy consumes the monitor's anomalies and the on-device skip needs
    the numerics probes.  Idempotent; call BEFORE constructing
    `TrainStep` (same rule as health)."""
    global _enabled
    with _state_lock:
        _health.enable()
        mon = _health.monitor()
        if mon is not None:
            mon.add_anomaly_listener(_tracker.note)
        _enabled = True


def disable() -> None:
    global _enabled
    with _state_lock:
        mon = _health.monitor()
        if mon is not None:
            mon.remove_anomaly_listener(_tracker.note)
        _tracker.reset()
        _enabled = False


def health_snapshot(step: Optional[int] = None,
                    margin: int = HEALTHY_MARGIN) -> Optional[dict]:
    """The health tag `CheckpointManager` stamps into a manifest at save
    time: ``{"healthy": bool, "anomaly_count": int, "last_anomaly_step"}``.
    ``healthy`` means no anomaly landed within `margin` steps of `step` —
    the rollback path only considers healthy-tagged checkpoints.  Returns
    None when the health subsystem is off (nothing to report, and legacy
    manifests stay byte-identical)."""
    if _health.monitor() is None:
        return None
    return _tracker.snapshot(step, margin)


# ---------------------------------------------------------------------------
# multi-process rollback consensus
# ---------------------------------------------------------------------------

def _process_group():
    """The default `torch.distributed` group when one is initialised and
    spans more than one process, else None (the single-process case)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.group.WORLD if dist.get_world_size() > 1 else None


def agree_step(step: int, timeout: Optional[float] = None) -> int:
    """Agree on a rollback/resume step across all processes: a
    timeout-guarded min-reduce over each process's newest-checkpoint step
    (the same retry policy as `elastic.sync_flag`).  The *min* is the safe
    choice: every process can restore a step it has a checkpoint for, so
    all processes restore the same step — or the consensus fails loudly
    and none do.

    Without an initialised `torch.distributed` group of more than one
    process: identity.  The collective (``all_reduce`` with ``MIN`` over
    a one-element int64 tensor, on the card for NCCL) runs on a worker
    thread so a peer that died mid-rollback cannot hang the caller
    forever; the default `timeout` is :func:`sync_timeout`
    (``MXTPU_ELASTIC_SYNC_TIMEOUT``).  On timeout this raises
    `SuspectedHostLoss`: the job must die and restart from checkpoints
    rather than let processes restore different steps and train on
    silently-diverged replicas."""
    fault_point("consensus_gather")
    from .base import MXNetError, SuspectedHostLoss
    group = _process_group()
    if group is None:
        return int(step)
    if timeout is None:
        timeout = sync_timeout()  # None (env 0) → unbounded, as documented

    def _reduce():
        import torch
        import torch.distributed as dist
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend(group) == "nccl" else torch.device("cpu")
        v = torch.tensor([int(step)], dtype=torch.int64, device=dev)
        dist.all_reduce(v, op=dist.ReduceOp.MIN, group=group)
        return int(v.item())

    try:
        return coordinated_round(
            _reduce, timeout=timeout, name="mxtpu-rollback-consensus",
            timeout_msg=
            f"recovery.agree_step: rollback consensus did not complete "
            f"within {timeout}s (a peer is likely down); aborting the "
            f"rollback — restart the job so every process restores from "
            f"its newest checkpoint")
    except SuspectedHostLoss:
        raise
    except Exception as e:
        raise MXNetError(
            f"recovery.agree_step: rollback consensus failed "
            f"({e}); processes cannot agree on a common restore "
            f"step — restart the job and resume from the newest "
            f"checkpoint") from e


# ---------------------------------------------------------------------------
# resumable preemption marker
# ---------------------------------------------------------------------------

def write_resume_marker(directory: str, info: dict) -> Optional[str]:
    """Atomically write the preemption resume marker. Best-effort: the
    marker is an optimization (explicit resume step), not the durability
    story — the checkpoint chain is."""
    path = os.path.join(directory, MARKER_NAME)
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(_tele.json_safe({"time": round(time.time(), 3),
                                       **info}), f, allow_nan=False)
        os.replace(tmp, path)
        return path
    except OSError as e:
        _log.warning("recovery: failed to write resume marker (%s)", e)
        return None


def read_resume_marker(directory: str) -> Optional[dict]:
    path = os.path.join(directory, MARKER_NAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def clear_resume_marker(directory: str) -> None:
    try:
        os.unlink(os.path.join(directory, MARKER_NAME))
    except OSError:
        pass


# ---------------------------------------------------------------------------
# the policy engine
# ---------------------------------------------------------------------------

class RecoveryPolicy:
    """Graded anomaly→remediation ladder over `HealthMonitor` anomalies.

    Attach to a monitor (:meth:`attach` — `ElasticLoop.run` does this for
    its default policy); anomalies arrive via the monitor's listener
    hook, remediation *requests* accumulate, and the training loop
    consumes them at safe points via :meth:`poll` — the policy never
    mutates training state itself, because a rollback must happen between
    steps, not inside an anomaly callback that may run mid-dispatch.

    ============  =========================================================
    tier 1 skip   ``nonfinite_grads``/``loss_nonfinite``: the on-device
                  guard already dropped the update; account it, back off
                  `scaler` (when attached), escalate past `skip_budget`
                  skips inside `skip_window_s`.
    tier 2        ``loss_spike``/``grad_explosion`` on
    rollback      `divergence_patience` consecutive steps: request a
                  rollback to the newest healthy-tagged checkpoint.
    tier 3 exit   more than `rollback_budget` rollbacks inside
                  `rollback_window_s`: request a clean stop (crash bundle
                  flushed by the loop).
    ============  =========================================================

    Anomalous step ids accumulate as the **poison window**; after a
    rollback the loop fast-forwards the data pipeline past them
    (:meth:`consume_poison`).
    """

    def __init__(self, skip_budget: Optional[int] = None,
                 rollback_budget: Optional[int] = None,
                 divergence_patience: int = 3,
                 skip_window_s: float = 600.0,
                 rollback_window_s: float = 1800.0,
                 scaler=None):
        self.skip_budget = (_env_int(ENV_SKIP_BUDGET, DEFAULT_SKIP_BUDGET)
                            if skip_budget is None else int(skip_budget))
        self.rollback_budget = (
            _env_int(ENV_ROLLBACK_BUDGET, DEFAULT_ROLLBACK_BUDGET)
            if rollback_budget is None else int(rollback_budget))
        self.divergence_patience = int(divergence_patience)
        self.skip_window_s = float(skip_window_s)
        self.rollback_window_s = float(rollback_window_s)
        #: optional amp.LossScaler backed off on every tier-1 skip
        self.scaler = scaler
        self.skips = 0
        self.rollbacks = 0
        self._lock = threading.RLock()
        self._monitor = None
        self._pending: Optional[dict] = None
        self._skip_times: deque = deque(maxlen=4096)   # (monotonic, step)
        self._last_skip_step: Optional[int] = None
        self._div_run = 0
        self._div_last_step: Optional[int] = None
        self._rollback_times: deque = deque(maxlen=256)
        self._poison: set = set()

    # -- monitor wiring -------------------------------------------------
    def attach(self, monitor=None) -> "RecoveryPolicy":
        """Subscribe to `monitor` (default: the process-wide one).
        Idempotent; listener-based, so user `on_anomaly` callbacks keep
        firing untouched."""
        mon = monitor if monitor is not None else _health.monitor()
        if mon is not None and mon is not self._monitor:
            self.detach()
            mon.add_anomaly_listener(self.on_anomaly)
            self._monitor = mon
        return self

    def detach(self) -> None:
        mon, self._monitor = self._monitor, None
        if mon is not None:
            mon.remove_anomaly_listener(self.on_anomaly)

    # -- anomaly ingestion ----------------------------------------------
    def on_anomaly(self, row: dict) -> None:
        """Monitor listener: classify one anomaly into the ladder."""
        rule = row.get("rule")
        step = row.get("step")
        if rule in ("nonfinite_grads", "loss_nonfinite"):
            self._tier1_skip(step, rule)
        elif rule in ("loss_spike", "grad_explosion"):
            self._divergence(step, rule)
        # loss_scale_collapse: the scaler is already at its floor; tier-1
        # backoffs cannot help and one collapse episode is not yet
        # divergence — recorded by the monitor, no remediation here.

    def _tier1_skip(self, step: Optional[int], rule: str) -> None:
        with self._lock:
            if step is not None and step == self._last_skip_step:
                return  # nonfinite_grads + loss_nonfinite on one step
            self._last_skip_step = step
            self.skips += 1
            now = time.monotonic()
            self._skip_times.append((now, step))
            if step is not None:
                self._poison.add(int(step))
            # honesty about what happened on device: the update was only
            # DROPPED if the on-device guard was armed when the step was
            # constructed.  A policy attached without recovery.enable() still
            # accounts/escalates (the anomaly is real), but must not
            # report a skip that never happened — the weights took the
            # hit, and the counter/diagnose output would lie about it.
            guarded = skip_enabled()
            if guarded:
                _tele.counter(
                    "recovery_skips_total",
                    "Optimizer updates dropped by the tier-1 non-finite "
                    "skip guard").inc()
            scale = None
            if self.scaler is not None:
                try:
                    if self._scaler_already_reacted():
                        # the training loop runs its own overflow-driven
                        # update_scale and just shrank for this same NaN
                        # step (anomalies retire a step or two after the
                        # loop's check) — a second backoff here would
                        # collapse the scale at factor^2 per bad step
                        scale = self.scaler.loss_scale
                        _log.info("recovery: scaler already reacted to "
                                  "this overflow; skipping backoff")
                    else:
                        scale = self.scaler.backoff()
                        _tele.counter(
                            "recovery_backoffs_total",
                            "AMP loss-scale backoffs applied by the "
                            "recovery policy").inc()
                except Exception:
                    _log.exception("recovery: loss-scale backoff failed")
            _tele.event("remediation", step=step, tier=1, kind="skip",
                        rule=rule, skips=self.skips, loss_scale=scale,
                        in_graph=guarded)
            _log.warning(
                "recovery: tier-1 skip at step %s (%s) — %s"
                "%s [%d skip(s) in window, budget %d]", step, rule,
                "update dropped on the device" if guarded else
                "WARNING: on-device guard unarmed, update APPLIED "
                "(call recovery.enable() before step construction)",
                "" if scale is None else f", loss scale backed off to "
                f"{scale:g}", self._skips_in_window(now), self.skip_budget)
            if self._skips_in_window(now) > self.skip_budget:
                self._request("rollback", "skip_budget", step)

    def _scaler_already_reacted(self) -> bool:
        """Whether the attached scaler's OWN update_scale path actually
        SHRANK the scale within the last couple of iterations — i.e. the
        training loop does its own AMP overflow handling and already
        penalized the step this anomaly describes.  Keyed on the
        loop-shrink marker, not on 'overflow observed': an overflow the
        tolerance window merely tolerated still needs the backoff (that
        immediate reaction is this policy's whole point).  A policy-only
        scaler (never fed update_scale) keeps the marker at -1 and the
        backoff always applies."""
        it = getattr(self.scaler, "_iter", None)
        last = getattr(self.scaler, "_last_loop_shrink_iter", None)
        if it is None or last is None or last < 0:
            return False
        return it - last <= 2

    def _skips_in_window(self, now: float) -> int:
        while self._skip_times and \
                now - self._skip_times[0][0] > self.skip_window_s:
            self._skip_times.popleft()
        return len(self._skip_times)

    def _divergence(self, step: Optional[int], rule: str) -> None:
        with self._lock:
            if step is not None:
                self._poison.add(int(step))
            if step is None or self._div_last_step is None:
                self._div_run = 1
            elif step == self._div_last_step:
                pass  # loss_spike AND grad_explosion on one step
            elif step == self._div_last_step + 1:
                self._div_run += 1
            else:
                self._div_run = 1
            self._div_last_step = step
            if self._div_run >= self.divergence_patience:
                self._request("rollback", "divergence", step)

    # -- remediation requests --------------------------------------------
    def _request(self, kind: str, reason: str,
                 step: Optional[int]) -> None:
        """Queue a remediation for the loop (caller holds the lock).  A
        rollback request while the budget is exhausted escalates straight
        to tier-3 exit."""
        if self._pending is not None:
            return
        tier = 2
        if kind == "rollback":
            now = time.monotonic()
            while self._rollback_times and \
                    now - self._rollback_times[0] > self.rollback_window_s:
                self._rollback_times.popleft()
            if len(self._rollback_times) >= self.rollback_budget:
                kind = "exit"
                reason = f"rollback_budget_exhausted({reason})"
                tier = 3
        if kind == "exit":
            tier = 3
        self._pending = {"kind": kind, "reason": reason, "step": step,
                         "tier": tier}
        _log.warning("recovery: requesting %s (%s) at step %s",
                     kind, reason, step)

    def request_rollback(self, reason: str = "manual",
                         step: Optional[int] = None) -> None:
        """Programmatic tier-2 request (custom rules, operators)."""
        with self._lock:
            self._request("rollback", reason, step)

    def poll(self) -> Optional[dict]:
        """Consume the pending remediation request, if any.  The training
        loop calls this once per step at a safe point (between steps)."""
        with self._lock:
            pending, self._pending = self._pending, None
            return pending

    # -- loop feedback ---------------------------------------------------
    def note_rollback(self, restored_step: int) -> None:
        """The loop reports a landed rollback: reset the escalation
        state so the replayed (clean) steps start from a blank slate, and
        charge the rollback budget."""
        with self._lock:
            self.rollbacks += 1
            self._rollback_times.append(time.monotonic())
            self._div_run = 0
            self._div_last_step = None
            self._skip_times.clear()
            self._last_skip_step = None
            # anomalies observed while the rollback drained in-flight
            # steps belong to the abandoned timeline; a request they
            # queued is moot now — acting on it would double-roll
            self._pending = None
        _tracker.reset()
        _tele.counter(
            "recovery_rollbacks_total",
            "Tier-2 rollbacks to a healthy checkpoint").inc()

    def consume_poison(self, restored_step: int) -> List[int]:
        """The anomalous step ids past `restored_step` — the poison
        window the replay fast-forwards over.  Clears the set."""
        with self._lock:
            poison = sorted(s for s in self._poison if s > restored_step)
            self._poison.clear()
            return poison

    def stats(self) -> dict:
        with self._lock:
            return {"skips": self.skips, "rollbacks": self.rollbacks,
                    "pending": dict(self._pending) if self._pending else None,
                    "divergence_run": self._div_run,
                    "poison": sorted(self._poison)}


# auto-enable from the environment, parent process only (mirrors health's
# guard: children must not re-install handlers)
_env = os.environ.get(ENV_ENABLE, "").strip()
if _env and _env.lower() not in ("0", "false", "no", "off") \
        and not _tele._in_child_process():
    enable()
del _env
