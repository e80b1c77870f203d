"""Training-health monitor: device-side numerics probes, a framework-wide
hang watchdog, and a crash flight recorder (counterpart of
``mxnet_tpu/health.py``: the same names, environment variables, rules,
metric and event names and bundle format).

Three cooperating pieces, all riding the `telemetry` substrate:

* **Numerics probes** — opt-in (``MXTPU_HEALTH=1`` or :func:`enable`)
  device-side reductions the `parallel.TrainStep` computes between the
  backward pass and the update: gradient global L2 norm and the
  non-finite element count over every gradient, both in f32, kept on the
  device beside the loss.  They ride the step's asynchronous dispatch —
  no extra host sync — and with health off at the step's construction
  the step launches nothing for them.  A host-side
  :class:`HealthMonitor` consumes the probes as steps retire and applies
  rolling-window anomaly rules: non-finite gradients, non-finite loss,
  loss spike vs an EMA, grad-norm explosion vs its EMA, and loss-scale
  collapse (fed by `amp.LossScaler.update_scale`).  Each rule emits
  ``health_*`` gauges/counters and an ``anomaly`` journal event carrying
  the offending step id.

* **Hang watchdog** — a process-wide heartbeat: `TrainStep` dispatch and
  retire and `elastic.Watchdog` each touch a named heartbeat
  (:func:`beat` — one dict store, always on).  A monitor thread declares a
  stall when NO heartbeat has been touched for ``MXTPU_STALL_TIMEOUT``
  seconds, dumps all-thread stacks (`faulthandler` to stderr + formatted
  into the bundle), a telemetry snapshot and the in-flight step ids, then
  either just records (default) or raises in the main thread
  (``MXTPU_STALL_ACTION=raise``).

* **Crash flight recorder** — a bounded ring of the last N journal events
  (fed by a `telemetry.add_event_tap`) plus the latest telemetry snapshot,
  flushed to ``MXTPU_CRASH_DIR`` (default ``<tmpdir>/mxtpu_crash_<uid>``)
  by ``sys.excepthook`` / ``atexit`` / SIGTERM handlers, so every abnormal
  exit leaves a post-mortem bundle (:func:`read_bundle`).

Everything here is stdlib-only at import time.
"""
from __future__ import annotations

import atexit
import faulthandler
import json
import logging
import math
import os
import signal
import sys
import threading
import time
import traceback
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from . import telemetry as _tele

__all__ = [
    "HealthMonitor", "FlightRecorder", "HangWatchdog",
    "enabled", "enable", "disable", "probes_enabled",
    "beat", "clear_beat", "heartbeat_ages", "healthz", "stall_timeout",
    "suppress_stalls", "stalls_suppressed",
    "monitor", "flight_recorder", "watchdog", "dump_bundle",
    "record_stall",
    "register_inflight_source", "read_bundle",
    "ENV_ENABLE", "ENV_STALL_TIMEOUT", "ENV_STALL_ACTION", "ENV_CRASH_DIR",
]

_log = logging.getLogger(__name__)

ENV_ENABLE = "MXTPU_HEALTH"
ENV_STALL_TIMEOUT = "MXTPU_STALL_TIMEOUT"
ENV_STALL_ACTION = "MXTPU_STALL_ACTION"
ENV_CRASH_DIR = "MXTPU_CRASH_DIR"

BUNDLE_PREFIX = "crash_"


# ---------------------------------------------------------------------------
# heartbeats — always-on, one dict store per touch
# ---------------------------------------------------------------------------

_beats: Dict[str, float] = {}
_beats_lock = threading.Lock()


def beat(name: str) -> None:
    """Touch the named heartbeat.  Called from every hot loop in the
    framework (train-step dispatch/retire, the elastic loop's steps);
    always on — one uncontended lock + dict store is cheaper
    than a guard would be, and /healthz should answer even when the
    watchdog is off.  The lock exists for the READERS: a first-ever beat
    from a new thread resizes the dict, and an unguarded
    ``max(_beats.values())`` in the watchdog would die with 'dictionary
    changed size during iteration'."""
    with _beats_lock:
        _beats[name] = time.monotonic()


def clear_beat(name: str) -> bool:
    """Retire a named heartbeat (True if it existed).  For per-entity
    beats whose entity is gone — a serving fleet names one heartbeat per
    replica (``serve.replica.<name>``), and a dead replica's frozen
    timestamp must not haunt /healthz or a supervisor's stall sweep."""
    with _beats_lock:
        return _beats.pop(name, None) is not None


def _beats_snapshot() -> Dict[str, float]:
    with _beats_lock:
        return dict(_beats)


def heartbeat_ages() -> Dict[str, float]:
    """Seconds since each named heartbeat was last touched."""
    now = time.monotonic()
    return {n: round(now - t, 3)
            for n, t in sorted(_beats_snapshot().items())}


_suppress_lock = threading.Lock()
_suppress_depth = 0


class _StallSuppression:
    """Context manager marking a window in which the hang watchdog must
    not fire — an expected long block with no heartbeats (the canonical
    case: building the CUDA kernels at a step's warmup)."""

    def __init__(self, reason: str = ""):
        self.reason = reason

    def __enter__(self):
        global _suppress_depth
        with _suppress_lock:
            _suppress_depth += 1
        return self

    def __exit__(self, *exc):
        global _suppress_depth
        with _suppress_lock:
            _suppress_depth -= 1
        # the window's end is progress — restart the idle clock from here
        beat("stall_suppression_end")
        return False


def suppress_stalls(reason: str = "") -> _StallSuppression:
    """Suppress watchdog stall detection for the enclosed block.
    `TrainStep.warmup` wraps its kernel build with this: minutes of
    ``nvcc`` are expected silence, not a hang."""
    return _StallSuppression(reason)


def stalls_suppressed() -> bool:
    return _suppress_depth > 0


def stall_timeout() -> Optional[float]:
    """``MXTPU_STALL_TIMEOUT`` parsed to seconds, or None (unset/invalid/
    non-positive).  `elastic.ElasticLoop` uses this as its watchdog
    default, so one env var arms both the loop-level and process-wide
    detectors."""
    raw = os.environ.get(ENV_STALL_TIMEOUT, "").strip()
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        _log.warning("ignoring non-numeric %s=%r", ENV_STALL_TIMEOUT, raw)
        return None
    return val if val > 0 else None


def healthz() -> dict:
    """The /healthz payload: heartbeat ages + watchdog/monitor state."""
    wd = _watchdog
    mon = _monitor
    return {
        "time": round(time.time(), 3),
        "enabled": _enabled,
        "heartbeats": heartbeat_ages(),
        "watchdog": None if wd is None else {
            "timeout": wd.timeout, "stalls": wd.stalls,
            "action": wd.action, "running": wd.running},
        "anomalies": 0 if mon is None else mon.anomaly_count,
        "steps_in_flight": _collect_inflight(),
    }


# ---------------------------------------------------------------------------
# in-flight step introspection (fed by TrainStep)
# ---------------------------------------------------------------------------

_inflight_sources: "weakref.WeakSet" = weakref.WeakSet()


def register_inflight_source(obj) -> None:
    """Track `obj` (anything with an ``_inflight`` deque of
    ``(step_id, ...)`` tuples — canonically `TrainStep`) so stall
    dumps and crash bundles can report which step ids were in flight.
    Weakly referenced: registration never extends the object's life."""
    _inflight_sources.add(obj)


def _collect_inflight() -> List[dict]:
    out = []
    for src in list(_inflight_sources):
        try:
            ids = [entry[0] for entry in list(getattr(src, "_inflight", ()))]
        except Exception:
            continue
        out.append({"source": type(src).__name__,
                    "count": len(ids), "ids": ids[-32:]})
    return out


def _all_thread_stacks() -> str:
    """Formatted stacks of every python thread (the evidence a hung
    collective leaves nowhere else) — pure-python so it can go into a
    JSON bundle, unlike faulthandler's fd-only dump."""
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks = []
    for tid, frame in sys._current_frames().items():
        chunks.append(f"--- thread {names.get(tid, '?')} (ident {tid}) ---\n"
                      + "".join(traceback.format_stack(frame)))
    return "\n".join(chunks)


# ---------------------------------------------------------------------------
# host-side anomaly rules
# ---------------------------------------------------------------------------

class HealthMonitor:
    """Rolling-window anomaly detection over per-step health probes.

    Feed it one :meth:`observe` per retired step (`TrainStep` does
    this automatically when probes are enabled) and loss-scale updates via
    :meth:`note_loss_scale` (wired into `amp.LossScaler`).  Rules:

    ==================  ====================================================
    ``nonfinite_grads``  any non-finite element in the gradient tree
    ``loss_nonfinite``   the loss itself is NaN/Inf
    ``loss_spike``       loss > ``loss_spike_factor`` x its EMA, after
                         ``min_history`` finite observations
    ``grad_explosion``   grad norm > ``grad_norm_factor`` x its EMA, after
                         ``min_history`` finite observations
    ``loss_scale_collapse``  the dynamic loss scale fell to
                         ``scale_collapse_at`` or below (the scaler is
                         pinned at its floor — gradients are underflowing
                         faster than the window can recover)
    ==================  ====================================================

    Every anomaly increments ``health_anomalies_total{rule=}``, records an
    ``anomaly`` journal event with the offending step id, appends to
    :attr:`anomalies` (a bounded ring — a run that diverges and keeps
    training for days must not grow the monitor without limit;
    :attr:`anomaly_count` keeps the true total), and invokes
    ``on_anomaly(anomaly_dict)`` when set — OUTSIDE the monitor's lock,
    so callbacks may safely call back into the monitor.  EMAs are only
    updated with FINITE values, so one NaN step cannot poison the
    baseline the next steps are judged against.
    """

    def __init__(self, window: int = 64, ema_alpha: float = 0.1,
                 loss_spike_factor: float = 10.0,
                 grad_norm_factor: float = 25.0,
                 min_history: int = 8,
                 scale_collapse_at: float = 2.0,
                 anomaly_capacity: int = 512,
                 on_anomaly: Optional[Callable[[dict], None]] = None):
        self.window = int(window)
        self.ema_alpha = float(ema_alpha)
        self.loss_spike_factor = float(loss_spike_factor)
        self.grad_norm_factor = float(grad_norm_factor)
        self.min_history = int(min_history)
        self.scale_collapse_at = float(scale_collapse_at)
        self.on_anomaly = on_anomaly
        self._listeners: List[Callable[[dict], None]] = []
        self.anomalies: deque = deque(maxlen=int(anomaly_capacity))
        self.anomaly_count = 0
        self.observations = 0
        self._lock = threading.Lock()
        self._loss_ema: Optional[float] = None
        self._gnorm_ema: Optional[float] = None
        self._finite_seen = 0
        self._recent = deque(maxlen=self.window)
        self._last_scale: Optional[float] = None
        self._scale_collapsed = False  # one anomaly per collapse episode
        self._gnorm_hist = None        # cached handle for the hot path

    # -- probes ---------------------------------------------------------
    def observe(self, step: int, loss: Optional[float] = None,
                grad_norm: Optional[float] = None,
                nonfinite: Optional[int] = None) -> None:
        """Ingest one retired step's probe values (host floats)."""
        fired: List[dict] = []
        with self._lock:
            self.observations += 1
            self._gauges(step, loss, grad_norm)
            if nonfinite:
                _tele.counter(
                    "health_nonfinite_total",
                    "Non-finite gradient elements seen by the numerics "
                    "probes").inc(int(nonfinite))
                self._anomaly("nonfinite_grads", step, fired,
                              count=int(nonfinite), loss=loss,
                              grad_norm=grad_norm)
            if loss is not None and not math.isfinite(loss):
                self._anomaly("loss_nonfinite", step, fired, loss=loss)
            elif loss is not None and self._finite_seen >= self.min_history \
                    and self._loss_ema is not None \
                    and loss > self.loss_spike_factor * max(
                        abs(self._loss_ema), 1e-12):
                self._anomaly("loss_spike", step, fired, loss=loss,
                              ema=round(self._loss_ema, 6),
                              factor=self.loss_spike_factor)
            if grad_norm is not None and not math.isfinite(grad_norm) \
                    and not nonfinite:
                # elements finite but the f32 norm reduction overflowed:
                # the MOST extreme explosion — without this branch it
                # would be the one divergence the monitor stays silent on
                # (nonfinite_grads needs nonfinite>0, the EMA rule needs
                # a finite norm)
                self._anomaly("grad_explosion", step, fired,
                              grad_norm=grad_norm, overflow=True)
            elif grad_norm is not None and math.isfinite(grad_norm) \
                    and self._finite_seen >= self.min_history \
                    and self._gnorm_ema is not None \
                    and grad_norm > self.grad_norm_factor * max(
                        self._gnorm_ema, 1e-12):
                self._anomaly("grad_explosion", step, fired,
                              grad_norm=grad_norm,
                              ema=round(self._gnorm_ema, 6),
                              factor=self.grad_norm_factor)
            self._update_baselines(step, loss, grad_norm, nonfinite)
        self._notify(fired)

    def _gauges(self, step, loss, grad_norm):
        if loss is not None and math.isfinite(loss):
            _tele.gauge("health_loss",
                        "Loss of the most recently retired step").set(loss)
        if grad_norm is not None and math.isfinite(grad_norm):
            _tele.gauge("health_grad_norm",
                        "Gradient global L2 norm of the most recently "
                        "retired step").set(grad_norm)
            if self._gnorm_hist is None:
                self._gnorm_hist = _tele.histogram(
                    "health_grad_norm_dist",
                    "Distribution of per-step gradient global norms",
                    buckets=(0.001, 0.01, 0.1, 1.0, 10.0, 100.0, 1000.0))
            self._gnorm_hist.observe(grad_norm)

    def _update_baselines(self, step, loss, grad_norm, nonfinite):
        finite_loss = loss is not None and math.isfinite(loss)
        if finite_loss:
            self._loss_ema = loss if self._loss_ema is None else \
                (1 - self.ema_alpha) * self._loss_ema + self.ema_alpha * loss
            _tele.gauge("health_loss_ema",
                        "EMA baseline the loss-spike rule compares "
                        "against").set(self._loss_ema)
        if grad_norm is not None and math.isfinite(grad_norm):
            self._gnorm_ema = grad_norm if self._gnorm_ema is None else \
                (1 - self.ema_alpha) * self._gnorm_ema \
                + self.ema_alpha * grad_norm
        if finite_loss and not nonfinite:
            self._finite_seen += 1
        self._recent.append({"step": step, "loss": loss,
                             "grad_norm": grad_norm,
                             "nonfinite": nonfinite})
        _tele.event("health_probe", step=step, loss=loss,
                    grad_norm=grad_norm, nonfinite=nonfinite)

    # -- loss scale (amp) -----------------------------------------------
    def note_loss_scale(self, scale: float,
                        step: Optional[int] = None) -> None:
        """Track the AMP dynamic loss scale (called by
        `amp.LossScaler.update_scale` when health is enabled).  A scale
        pinned at/below `scale_collapse_at` means every window overflows —
        the classic silent-divergence signature."""
        fired: List[dict] = []
        with self._lock:
            _tele.gauge("health_loss_scale",
                        "Current AMP dynamic loss scale").set(scale)
            if scale <= self.scale_collapse_at:
                if not self._scale_collapsed:
                    self._scale_collapsed = True
                    self._anomaly("loss_scale_collapse", step, fired,
                                  scale=scale,
                                  floor=self.scale_collapse_at)
            elif self._last_scale is not None \
                    and scale > self._last_scale:
                # the scale grew back above the floor: new episode
                self._scale_collapsed = False
            self._last_scale = scale
        self._notify(fired)

    # -- shared anomaly sink --------------------------------------------
    def _anomaly(self, rule: str, step: Optional[int],
                 fired: List[dict], **details) -> None:
        """Record one anomaly (caller holds the lock).  The row is also
        appended to `fired` so the caller can run `on_anomaly` AFTER
        releasing the lock — a callback that calls back into the monitor
        must not deadlock."""
        details = {k: v for k, v in details.items() if v is not None}
        row = {"rule": rule, "step": step, "time": round(time.time(), 3),
               **details}
        self.anomalies.append(row)
        self.anomaly_count += 1
        fired.append(row)
        _tele.counter("health_anomalies_total",
                      "Training-health anomalies by rule",
                      labelnames=("rule",)).inc(rule=rule)
        _tele.event("anomaly", step=step, rule=rule, **details)
        _log.warning("health anomaly [%s] at step %s: %s", rule, step,
                     details)

    # -- anomaly listeners ----------------------------------------------
    def add_anomaly_listener(self, fn: Callable[[dict], None]) -> None:
        """Subscribe `fn(anomaly_dict)` alongside `on_anomaly`.  The
        listener list exists so subsystems (the recovery policy engine,
        the manifest health tracker) can subscribe without clobbering a
        user's `on_anomaly` callback.  Idempotent per function."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_anomaly_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def _notify(self, fired: List[dict]) -> None:
        if not fired:
            return
        with self._lock:
            sinks = list(self._listeners)
        if self.on_anomaly is not None:
            sinks.insert(0, self.on_anomaly)
        for row in fired:
            for cb in sinks:
                try:
                    cb(row)
                except Exception:
                    _log.exception("health anomaly callback failed")

    def recent(self) -> List[dict]:
        """The last <=`window` probe observations (for bundles/tools)."""
        with self._lock:
            return list(self._recent)

    def anomalies_snapshot(self) -> List[dict]:
        """Locked copy of the anomaly ring: bundle flushes run on other
        threads, and an unguarded `list(deque)` racing an append dies
        with 'deque mutated during iteration' — aborting the post-mortem
        at the moment it matters."""
        with self._lock:
            return list(self.anomalies)


# ---------------------------------------------------------------------------
# crash flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded ring of the last `capacity` journal events plus enough
    context to reconstruct "what was the run doing when it died":
    telemetry snapshot, heartbeat ages, in-flight step ids, recent health
    probes, and all-thread stacks.  :meth:`flush` writes one JSON bundle
    per abnormal exit into `crash_dir`."""

    def __init__(self, crash_dir: Optional[str] = None, capacity: int = 256):
        self.crash_dir = crash_dir
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._last_step = 0
        self.flushed: List[str] = []

    # the telemetry.event tap target
    def record_event(self, row: dict) -> None:
        with self._lock:
            if row.get("step") is not None:
                self._last_step = row["step"]
            else:
                row = dict(row)
                row["step"] = self._last_step
            self._events.append(row)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def bundle(self, reason: str, exc_info=None) -> dict:
        """Assemble (but do not write) a post-mortem bundle dict."""
        out = {
            "bundle_version": 1,
            "reason": reason,
            "time": round(time.time(), 3),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "last_step": self._last_step,
            "heartbeats": heartbeat_ages(),
            "steps_in_flight": _collect_inflight(),
            "events": self.events(),
        }
        mon = _monitor
        if mon is not None:
            out["anomaly_count"] = mon.anomaly_count
            out["anomalies"] = mon.anomalies_snapshot()
            out["recent_probes"] = mon.recent()
        try:
            out["metrics"] = _tele.snapshot()
        except Exception as e:
            out["metrics_error"] = repr(e)
        if exc_info is not None:
            tp, val, tb = exc_info
            out["exception"] = {
                "type": getattr(tp, "__name__", str(tp)),
                "message": str(val),
                "traceback": "".join(
                    traceback.format_exception(tp, val, tb))[-20000:],
            }
        try:
            out["stacks"] = _all_thread_stacks()[-40000:]
        except Exception:
            pass
        return out

    def flush(self, reason: str, exc_info=None) -> Optional[str]:
        """Write one bundle to `crash_dir`; returns its path (None when no
        crash dir is configured or the write failed — a post-mortem must
        never raise INTO the exit path it documents)."""
        if not self.crash_dir:
            return None
        try:
            os.makedirs(self.crash_dir, mode=0o700, exist_ok=True)
            path = os.path.join(
                self.crash_dir,
                f"{BUNDLE_PREFIX}{int(time.time())}_{os.getpid()}_"
                f"{len(self.flushed)}.json")
            with open(path, "w") as f:
                json.dump(_tele.json_safe(self.bundle(reason,
                                                      exc_info=exc_info)),
                          f, default=str, allow_nan=False)
            self.flushed.append(path)
            _log.error("health: %s — post-mortem bundle written to %s",
                       reason, path)
            return path
        except Exception as e:
            _log.warning("health: failed to write crash bundle (%s)", e)
            return None


def read_bundle(path: str) -> dict:
    """Parse a flight-recorder bundle back (tools, tests)."""
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# hang watchdog
# ---------------------------------------------------------------------------

class HangWatchdog:
    """Process-wide stall detector over the named heartbeats.

    A daemon thread wakes every ``min(timeout/4, 1s)`` and measures the
    age of the MOST RECENT heartbeat touch (any component making progress
    resets the clock — a helper thread idling behind a healthy train loop
    is not a stall).  When that age exceeds `timeout` it:

    1. dumps all-thread stacks via `faulthandler` to stderr,
    2. records a ``stall`` journal event + ``health_stalls_total`` counter
       with the heartbeat ages and in-flight step ids,
    3. flushes a flight-recorder bundle (reason ``stall``), and
    4. applies `action`: ``"record"`` (default) keeps running;
       ``"raise"`` interrupts the main thread with KeyboardInterrupt —
       delivered as a real SIGINT when the default handler is installed
       (so a main thread blocked in ``sleep``/IO wakes via EINTR), else
       via ``_thread.interrupt_main`` (lands at the next bytecode
       boundary; a wedged *native* collective surfaces it only on
       return, but the dump in (1) already captured where it is stuck).
       A ``raise`` watchdog fires once, then stops itself.

    In ``record`` mode the clock rebaselines after firing, so a
    persistent hang fires once per `timeout` window, not once per poll.
    """

    def __init__(self, timeout: float, action: str = "record",
                 poll: Optional[float] = None,
                 on_stall: Optional[Callable[[dict], None]] = None,
                 names: Optional[Sequence[str]] = None,
                 source: str = "health_watchdog"):
        if timeout <= 0:
            raise ValueError("watchdog timeout must be positive")
        if action not in ("record", "raise"):
            raise ValueError(f"unknown watchdog action {action!r} "
                             f"(expected 'record' or 'raise')")
        self.timeout = float(timeout)
        self.action = action
        self.on_stall = on_stall
        # restrict liveness to these heartbeat names (None = any beat is
        # progress).  `elastic.Watchdog` scopes its shim instance to the
        # 'elastic_step' beat so its contract — "no completed step within
        # timeout" — survives a busy prefetcher; stall *reporting* still
        # goes through the one shared record_stall path, labeled `source`.
        self.names = None if names is None else frozenset(names)
        self.source = source
        self.stalls = 0
        self._poll = poll if poll is not None else min(timeout / 4.0, 1.0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._baseline = time.monotonic()
        self._fired_once = False
        self._last_fired_beat: Optional[float] = None
        self._interrupted = False

    def start(self) -> "HangWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._baseline = time.monotonic()
            self._fired_once = False
            self._interrupted = False
            self._thread = threading.Thread(
                target=self._watch, name="mxtpu-health-watchdog",
                daemon=True)
            self._thread.start()
        return self

    @property
    def running(self) -> bool:
        """Whether the monitor thread is alive.  A raise-mode watchdog
        exits after its one interruption; callers (`enable`, `/healthz`)
        must not mistake the armed-looking object for active coverage."""
        t = self._thread
        return t is not None and t.is_alive()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        self._thread = None

    def _beats(self) -> Dict[str, float]:
        beats = _beats_snapshot()
        if self.names is not None:
            beats = {n: t for n, t in beats.items() if n in self.names}
        return beats

    def _last_activity(self) -> float:
        beats = self._beats()
        last = self._baseline
        if beats:
            last = max(last, max(beats.values()))
        return last

    def _watch(self) -> None:
        while not self._stop.wait(self._poll):
            try:
                if stalls_suppressed():
                    # an announced long block (a kernel build): expected
                    # silence is not idleness — keep resetting the clock
                    self._baseline = time.monotonic()
                    continue
                activity = self._last_activity()
                idle = time.monotonic() - activity
                if idle <= self.timeout:
                    continue
                self._fire(idle)
            except Exception:  # the detector must outlive its handler
                _log.exception("health watchdog handler failed")
            if self._interrupted:
                return  # raise mode, interrupt DELIVERED: one is enough;
                        # don't refire into the teardown it triggers.  A
                        # fire that died before its action keeps watching.
            # rebaseline so a persistent hang refires per window, not
            # per poll
            self._baseline = time.monotonic()

    def _fire(self, idle: float) -> None:
        self.stalls += 1
        ages = heartbeat_ages()
        inflight = _collect_inflight()
        _log.error(
            "health watchdog: STALL — no heartbeat for %.1fs "
            "(timeout %.1fs); heartbeat ages: %s; dumping stacks",
            idle, self.timeout, ages)
        try:
            faulthandler.dump_traceback(file=sys.stderr)
        except Exception:
            pass
        # one BUNDLE per hang episode: in record mode a weekend-long hang
        # refires every window — re-log and re-count it, but don't fill
        # the crash dir with an identical multi-MB bundle per window.
        # Episode identity is the newest HEARTBEAT timestamp (not
        # _last_activity(), which moves with the post-fire rebaseline):
        # it only changes when some component actually made progress
        # between fires, i.e. a genuinely new hang.
        beats = self._beats()
        newest_beat = max(beats.values()) if beats else None
        new_episode = (not self._fired_once
                       or newest_beat != self._last_fired_beat)
        self._fired_once = True
        self._last_fired_beat = newest_beat
        record_stall(self.source, self.timeout, idle=idle,
                     dump=new_episode)
        if self.on_stall is not None:
            try:
                self.on_stall({"idle": idle, "heartbeats": ages,
                               "steps_in_flight": inflight})
            except Exception:
                _log.exception("health on_stall callback failed")
        if self.action == "raise":
            _log.error("health watchdog: interrupting main thread "
                       "(MXTPU_STALL_ACTION=raise)")
            self._interrupted = True
            try:
                # a real SIGINT wakes a main thread blocked in sleep/IO
                # (EINTR); only valid while the default KeyboardInterrupt
                # disposition is installed
                if signal.getsignal(signal.SIGINT) is \
                        signal.default_int_handler:
                    os.kill(os.getpid(), signal.SIGINT)
                    return
            except (OSError, ValueError):
                pass
            import _thread
            _thread.interrupt_main()


# ---------------------------------------------------------------------------
# process-wide state + crash handlers
# ---------------------------------------------------------------------------

_enabled = False
_monitor: Optional[HealthMonitor] = None
_recorder: Optional[FlightRecorder] = None
_watchdog: Optional[HangWatchdog] = None
_state_lock = threading.Lock()
_prev_excepthook = None
_prev_sigterm = None
_atexit_registered = False


def enabled() -> bool:
    return _enabled


def probes_enabled() -> bool:
    """Gate for the DEVICE-side probe computations.  `TrainStep` reads this
    once at construction: with health off then, the step launches nothing
    for the probes, whatever is enabled later."""
    return _enabled


def monitor() -> Optional[HealthMonitor]:
    return _monitor


def flight_recorder() -> Optional[FlightRecorder]:
    return _recorder


def watchdog() -> Optional[HangWatchdog]:
    return _watchdog


def dump_bundle(reason: str, exc_info=None) -> Optional[str]:
    """Flush a post-mortem bundle now (watchdog/elastic/tests call this
    for abnormal conditions that are not process exits)."""
    rec = _recorder
    if rec is None:
        return None
    return rec.flush(reason, exc_info=exc_info)


def record_stall(source: str, timeout: float, idle: Optional[float] = None,
                 dump: bool = True) -> Optional[str]:
    """Uniform stall accounting for any hang detector (the process-wide
    `HangWatchdog` and the loop-level `elastic.Watchdog` both use it, so
    the event shape, counter, and bundle policy cannot drift apart):
    increments ``health_stalls_total``, records a ``stall`` journal
    event carrying the source, heartbeat ages, and in-flight step ids,
    and — when `dump` — flushes a flight-recorder bundle.  Returns the
    bundle path if one was written."""
    ages = heartbeat_ages()
    inflight = _collect_inflight()
    _tele.counter("health_stalls_total",
                  "Watchdog-declared stalls (no heartbeat/step completion "
                  "within the stall timeout)").inc()
    _tele.event("stall", source=source, timeout=timeout,
                idle_seconds=None if idle is None else round(idle, 3),
                heartbeats=ages, steps_in_flight=inflight)
    if dump:
        return dump_bundle("stall")
    return None


def _default_crash_dir() -> str:
    """Per-user default under the tmpdir: a fixed shared path on a
    multi-user host would collide (first user owns it, everyone else's
    flushes EACCES into the swallow-all except) and leak bundle contents
    (argv, paths, metric values) to other local users."""
    import tempfile
    uid = getattr(os, "getuid", lambda: "u")()
    return os.path.join(tempfile.gettempdir(), f"mxtpu_crash_{uid}")


def enable(crash_dir: Optional[str] = None,
           stall_timeout_s: Optional[float] = None,
           stall_action: Optional[str] = None,
           monitor_kwargs: Optional[dict] = None,
           ring_capacity: int = 256) -> None:
    """Turn the training-health subsystem on.

    Implies `telemetry.enable()` — the probes, anomaly events, and
    bundles all ride the telemetry substrate.  `crash_dir` defaults to
    ``MXTPU_CRASH_DIR``, else ``<tmpdir>/mxtpu_crash``.  The watchdog
    starts only when a stall timeout is configured (`stall_timeout_s` or
    ``MXTPU_STALL_TIMEOUT``); `stall_action` defaults to
    ``MXTPU_STALL_ACTION`` else ``record``.  Idempotent; call BEFORE
    constructing `TrainStep` — the probes are fixed at the step's
    construction, and enabling later needs a new step."""
    global _enabled, _monitor, _recorder, _watchdog
    global _prev_excepthook, _prev_sigterm, _atexit_registered
    with _state_lock:
        _tele.enable()
        if _monitor is None:
            _monitor = HealthMonitor(**(monitor_kwargs or {}))
        if _recorder is None:
            if crash_dir is None:
                crash_dir = os.environ.get(ENV_CRASH_DIR, "").strip() \
                    or _default_crash_dir()
            _recorder = FlightRecorder(crash_dir=crash_dir,
                                       capacity=ring_capacity)
            _tele.add_event_tap(_recorder.record_event)
        explicit = stall_timeout_s is not None or stall_action is not None
        if stall_timeout_s is None:
            stall_timeout_s = stall_timeout()
        if stall_action is None:
            # env values degrade gracefully (mirroring stall_timeout):
            # a miscased MXTPU_STALL_ACTION must not brick the import
            # via the module-level auto-enable.  An explicit
            # python-arg typo still raises in HangWatchdog.
            env_action = os.environ.get(
                ENV_STALL_ACTION, "").strip().lower()
            if env_action and env_action not in ("record", "raise"):
                _log.warning(
                    "ignoring unknown %s=%r (expected 'record' or "
                    "'raise'); using 'record'", ENV_STALL_ACTION,
                    env_action)
                env_action = ""
            stall_action = env_action or "record"
        if stall_timeout_s:
            # an EXPLICIT reconfiguration replaces a running watchdog —
            # silently keeping the old timeout/action would drop the
            # caller's request; env-derived re-enables leave it alone
            if _watchdog is not None and _watchdog.running and explicit \
                    and (_watchdog.timeout != float(stall_timeout_s)
                         or _watchdog.action != stall_action):
                _watchdog.stop()
            # a raise-mode watchdog's thread exits after its one
            # interruption: a dead watchdog is absent — re-arm coverage
            if _watchdog is None or not _watchdog.running:
                _watchdog = HangWatchdog(stall_timeout_s,
                                         action=stall_action).start()
        _install_crash_handlers()
        if not _atexit_registered:
            atexit.register(_atexit_flush)
            _atexit_registered = True
        _enabled = True


def disable() -> None:
    """Stop the watchdog, detach the recorder tap, restore the crash
    handlers.  Recorded anomalies/bundles stay readable."""
    global _enabled, _monitor, _recorder, _watchdog
    with _state_lock:
        _enabled = False
        if _watchdog is not None:
            _watchdog.stop()
            _watchdog = None
        if _recorder is not None:
            _tele.remove_event_tap(_recorder.record_event)
            _recorder = None
        _monitor = None
        _uninstall_crash_handlers()


# -- crash handlers ---------------------------------------------------------

def _excepthook(tp, val, tb):
    rec = _recorder
    if rec is not None:
        rec.flush("exception", exc_info=(tp, val, tb))
    hook = _prev_excepthook or sys.__excepthook__
    hook(tp, val, tb)


def _on_sigterm(signum, frame):
    rec = _recorder
    if rec is not None:
        # flush on a WORKER thread with a bounded join: this handler runs
        # on the main thread between bytecodes, and the interrupted frame
        # may hold one of the non-reentrant locks the bundle path takes
        # (_beats_lock, monitor/recorder/registry locks) — a direct flush
        # would deadlock the process instead of terminating it.  Those
        # critical sections are microseconds long, so the worker
        # normally finishes instantly; in the pathological overlap the
        # join times out and we chain onward (bundle lost, no hang).
        t = threading.Thread(target=rec.flush, args=("sigterm",),
                             daemon=True)
        t.start()
        t.join(timeout=10.0)
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    elif prev == signal.SIG_DFL:
        # re-deliver with the default disposition so the exit status
        # still says "killed by SIGTERM"
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def _atexit_flush():
    """Exit backstop: a process that dies via `sys.exit`/`os._exit`-free
    paths after recording anomalies or stalls still leaves a bundle, even
    though no exception reached the excepthook.  Clean healthy exits
    write nothing."""
    rec, mon, wd = _recorder, _monitor, _watchdog
    if rec is None or rec.flushed:
        return
    abnormal = (mon is not None and mon.anomalies) or \
        (wd is not None and wd.stalls)
    if abnormal:
        rec.flush("atexit_abnormal")


def _install_crash_handlers():
    global _prev_excepthook, _prev_sigterm
    if _prev_excepthook is None and sys.excepthook is not _excepthook:
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
    if _prev_sigterm is None \
            and threading.current_thread() is threading.main_thread():
        try:
            current = signal.getsignal(signal.SIGTERM)
            # getsignal() == None means a handler installed from C that
            # python cannot chain to — installing ours would SWALLOW
            # SIGTERM for the host process; leave such embeddings alone
            if current is not _on_sigterm and current is not None:
                _prev_sigterm = current
                signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            pass  # non-main thread / exotic embedding: no signal hook


def _uninstall_crash_handlers():
    global _prev_excepthook, _prev_sigterm
    if _prev_excepthook is not None:
        if sys.excepthook is _excepthook:
            sys.excepthook = _prev_excepthook
            _prev_excepthook = None
        # else: another library wrapped our hook since enable(); keep the
        # saved one so _excepthook (still reachable through the wrapper)
        # chains to it instead of silently dropping it
    if _prev_sigterm is not None:
        if threading.current_thread() is threading.main_thread():
            try:
                if signal.getsignal(signal.SIGTERM) is _on_sigterm:
                    signal.signal(signal.SIGTERM, _prev_sigterm)
                _prev_sigterm = None
            except (ValueError, OSError):
                pass
        # non-main thread cannot touch signal dispositions: KEEP the
        # saved handler so _on_sigterm still chains to it and a later
        # main-thread disable (or re-enable) can restore it — clearing
        # it here would turn SIGTERM into a swallowed no-op


# auto-enable from the environment, parent process only (children must not
# each install crash handlers / open bundles — mirrors telemetry's
# auto-enable guard)
_env = os.environ.get(ENV_ENABLE, "").strip()
if _env and _env.lower() not in ("0", "false", "no", "off") \
        and not _tele._in_child_process():
    enable()
del _env
