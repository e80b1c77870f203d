"""Shared resilience primitives: bounded retry + deterministic fault injection
(counterpart of ``mxnet_tpu/resilience.py``, the same names, environment
variable and spec grammar).

The recovery code in `elastic.py` and `utils/checkpoint.py` shares two
building blocks that live here, dependency-free (the module imports only
the standard library):

* :func:`retry_with_backoff` — call a flaky operation with exponential
  backoff + jitter, retrying only an explicit exception allowlist.
* an env-driven fault-point registry — every recovery path passes through
  a **named injection point** (:func:`fault_point`), and
  ``MXTPU_FAULT_SPEC`` arms specific points to fail on specific hits.
  The spec travels through the environment, so it crosses a process
  boundary.  This generalizes the step-only `elastic.FailureInjector`.

Spec grammar (comma-separated entries)::

    MXTPU_FAULT_SPEC = entry[,entry...]
    entry            = point@hit[:action]
    point            = injection point name (ckpt_write, ckpt_read,
                       elastic_step, rollback_restore, preempt_save,
                       consensus_gather, ...)
    hit              = 1-based occurrence count, per process: the fault
                       fires the hit-th time the point is reached
    action           = builtin exception name (OSError, ValueError, ...)
                       | "exit"  (raises `FaultExit`, a BaseException the
                          hosting site turns into a hard process exit)
                       default: FaultInjected (a RuntimeError, so the
                       elastic retry path treats it as transient)

Example: ``MXTPU_FAULT_SPEC=ckpt_read@1,elastic_step@3`` makes the first
checkpoint load raise (exercising the fallback chain) and the third step
attempt of an `elastic.ElasticLoop` fail (exercising restore-and-retry).

Each armed entry fires **once per process**; hit counts are per point
name and only advance while a spec is armed, so production runs (no env
var) pay one dict lookup per fault point.
"""
from __future__ import annotations

import builtins
import logging
import os
import random
import time
from typing import Callable, Dict, Optional, Sequence

__all__ = ["retry_with_backoff", "FaultInjected", "FaultExit",
           "FaultRegistry", "fault_point", "fault_registry", "ENV_VAR"]

_log = logging.getLogger(__name__)

ENV_VAR = "MXTPU_FAULT_SPEC"

# distinctive exit code so a supervised worker killed by injection is
# distinguishable from a real crash in test assertions
EXIT_CODE = 86


class FaultInjected(RuntimeError):
    """Raised by an armed fault point. Subclasses RuntimeError so the
    elastic restore-retry path treats it like any transient step error."""


class FaultExit(BaseException):
    """Raised for the ``exit`` action. The site hosting the fault point
    converts it into a hard ``os._exit(EXIT_CODE)`` after flushing what it
    already delivered — a process death a supervisor must recover from.
    BaseException, so generic ``except Exception`` error-shipping cannot
    swallow it."""


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

def retry_with_backoff(fn: Callable[[], object], *, retries: int = 3,
                       base_delay: float = 0.05, max_delay: float = 2.0,
                       jitter: float = 0.5, full_jitter: bool = False,
                       max_elapsed: Optional[float] = None,
                       retry_on: Sequence[type] = (OSError,),
                       on_retry: Optional[Callable] = None,
                       sleep: Callable[[float], None] = time.sleep,
                       clock: Callable[[], float] = time.monotonic):
    """Call ``fn()`` retrying listed exceptions with exponential backoff.

    Only exceptions in `retry_on` are retried — anything else propagates
    immediately (a typo'd path must not be retried like a network blip).
    Even when `retry_on` names a broad base class, non-``Exception``
    ``BaseException``\\ s (`FaultExit`, ``KeyboardInterrupt``,
    ``SystemExit``) are NEVER retried: a fault-injected process exit or a
    user's Ctrl-C swallowed by a retry wrapper would defeat the very
    teardown it requested.

    Delay for attempt *k* is ``base_delay * 2**(k-1)`` capped at
    `max_delay`, plus up to ``jitter`` fraction of itself (decorrelates
    retry storms across hosts); ``full_jitter=True`` draws the whole
    delay uniformly from ``[0, capped)`` instead (the AWS "full jitter"
    policy — better decorrelation when many hosts retry the same shared
    service).  `max_elapsed` is an overall deadline in seconds: once the
    elapsed time plus the upcoming delay would exceed it, the last
    exception propagates instead of starting another sleep — a retry
    loop inside a preemption grace window must not outlive the window.
    After `retries` failed retries the last exception propagates
    unchanged. `on_retry(attempt, exc, delay)` is invoked before each
    sleep; `sleep`/`clock` are injectable for tests.
    """
    retry_on = tuple(retry_on)
    attempt = 0
    start = clock()
    while True:
        try:
            return fn()
        except retry_on as e:
            if not isinstance(e, Exception):
                raise  # BaseException-only (FaultExit, KeyboardInterrupt)
            attempt += 1
            if attempt > retries:
                raise
            delay = min(base_delay * (2.0 ** (attempt - 1)), max_delay)
            if full_jitter:
                delay = random.uniform(0.0, delay)
            else:
                delay += random.uniform(0.0, jitter * delay)
            if max_elapsed is not None and \
                    clock() - start + delay > max_elapsed:
                _log.warning(
                    "retry budget exhausted after %.3fs (max_elapsed "
                    "%.3fs); raising %s", clock() - start, max_elapsed,
                    type(e).__name__)
                raise
            if on_retry is not None:
                on_retry(attempt, e, delay)
            _log.warning("retry %d/%d after %s: %s (sleeping %.3fs)",
                         attempt, retries, type(e).__name__, e, delay)
            sleep(delay)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

def _resolve_action(token: str):
    if token in ("exit", "kill"):
        return "exit"
    exc = getattr(builtins, token, None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        return exc
    raise ValueError(
        f"{ENV_VAR}: unknown action {token!r} (expected a builtin "
        f"exception name or 'exit')")


class FaultRegistry:
    """Parsed ``MXTPU_FAULT_SPEC``: {point -> {hit_no -> action}} plus
    per-point hit counters. Parse errors raise ValueError eagerly — a
    typo'd spec silently injecting nothing would defeat the test using it.
    """

    def __init__(self, spec: str = ""):
        self.spec = spec
        self._plan: Dict[str, Dict[int, object]] = {}
        self._counts: Dict[str, int] = {}
        for raw in spec.split(","):
            entry = raw.strip()
            if not entry:
                continue
            if "@" not in entry:
                raise ValueError(f"{ENV_VAR}: bad entry {entry!r} "
                                 f"(expected point@hit[:action])")
            point, _, rest = entry.partition("@")
            hit_s, _, action_s = rest.partition(":")
            try:
                hit = int(hit_s)
            except ValueError:
                raise ValueError(f"{ENV_VAR}: bad hit count in {entry!r}")
            if hit < 1:
                raise ValueError(f"{ENV_VAR}: hit counts are 1-based "
                                 f"({entry!r})")
            action = _resolve_action(action_s) if action_s else FaultInjected
            self._plan.setdefault(point, {})[hit] = action

    @property
    def armed(self) -> bool:
        return bool(self._plan)

    def hits(self, name: str) -> int:
        return self._counts.get(name, 0)

    def fire(self, name: str) -> None:
        """Record a hit of injection point `name`; raise (or exit) if the
        spec arms this hit. Each armed hit fires at most once."""
        if not self._plan:
            return
        n = self._counts[name] = self._counts.get(name, 0) + 1
        action = self._plan.get(name, {}).pop(n, None)
        if action is None:
            return
        # telemetry is imported lazily HERE (armed-and-firing is the rare
        # path) so importing this module stays free
        try:
            from . import telemetry as _tele
            if _tele.enabled():
                _tele.counter(
                    "fault_triggers",
                    "Armed fault-injection points that fired",
                    labelnames=("point",)).inc(point=name)
                _tele.event(
                    "fault_trigger", point=name, hit=n,
                    action="exit" if action == "exit" else action.__name__)
        except Exception:  # telemetry must never mask the injected fault
            pass
        if action == "exit":
            _log.error("fault injection: exit requested at point %r "
                       "(hit %d)", name, n)
            raise FaultExit(name, n)
        _log.warning("fault injection: raising %s at point %r (hit %d)",
                     action.__name__, name, n)
        raise action(f"injected fault at point '{name}' (hit {n})")


_active: Optional[FaultRegistry] = None


def fault_registry() -> FaultRegistry:
    """The process-wide registry for the CURRENT value of the env var.
    Re-parsed (with fresh hit counters) whenever the env value changes, so
    tests get deterministic counts without explicit reset plumbing."""
    global _active
    spec = os.environ.get(ENV_VAR, "")
    if _active is None or _active.spec != spec:
        _active = FaultRegistry(spec)
    return _active


def fault_point(name: str) -> None:
    """Mark a named injection point. No-op (one env lookup) unless
    ``MXTPU_FAULT_SPEC`` arms this point."""
    fault_registry().fire(name)
