"""Profiler facade (counterpart of ``mxnet_tpu/profiler.py``; parity:
`python/mxnet/profiler.py:34,125,154` over `src/profiler/profiler.h:263`).

The reference collects engine-op stats into chrome://tracing JSON plus an
aggregate per-op table (`src/profiler/aggregate_stats.cc`).  Here MXNet's
`set_config` / `set_state` / `start` / `stop` / `pause` / `resume` /
`dump` / `dumps` drive ``torch.profiler`` (CPU activity, and the card's
through CUPTI when one is visible):

- `dump` writes one Chrome trace (open it in chrome://tracing or
  https://ui.perfetto.dev): the profiler's own events (torch ops, CUDA
  kernels, ``record_function`` ranges) plus the user scopes below, on the
  same wall clock;
- `dumps` renders the aggregate table: every user scope and marker, and,
  when ``aggregate_stats=True``, every torch op of the last profiled
  session from ``key_averages()`` (count and host time; ``Device Time``
  columns are the op's CUDA time where the profiler saw the card);
- user scopes (`scope`, `Task`, `Frame`, `Event`) are
  ``torch.profiler.record_function`` ranges in the trace and rows of the
  table; `pause` / `resume` stop and restart the collection of torch ops
  (``toggle_collection_dynamic``) while the scopes keep recording, as
  JAX's stop and restart its op hook;
- `step_annotation` marks a training step in the trace (`TrainStep`
  wraps every dispatch in one).
"""
from __future__ import annotations

import json as _json
import os
import tempfile
import threading
import time
from typing import Optional

__all__ = [
    "set_config", "set_state", "start", "stop", "pause", "resume", "dump",
    "dumps", "state", "scope", "Task", "Frame", "Event", "Counter",
    "Marker", "step_annotation",
]


def step_annotation(name: str = "train", step_num: Optional[int] = None):
    """Step-boundary marker for the trace: a ``record_function`` range
    named ``<name>#<step_num>``.  `TrainStep.dispatch` wraps every step
    in one; cheap when no profiler runs — safe to leave on every step."""
    import torch
    label = name if step_num is None else f"{name}#{step_num}"
    return torch.profiler.record_function(label)


_config = {"profile_all": False, "filename": "profile_output",
           "aggregate_stats": False, "running": False}

# name -> [count, total_s, min_s, max_s]; guarded by _agg_lock
_agg: dict = {}
_agg_lock = threading.Lock()
_counters: dict = {}
# user-scope chrome events [(name, t_begin_s, dur_s, tid)], bounded
_events: list = []
_MAX_EVENTS = 200_000
# the running torch.profiler session and the op rows of the last one
_prof = None
_op_rows: list = []


def _record_stat(name: str, elapsed_s: float) -> None:
    now = time.time()
    warn_cap = False
    with _agg_lock:
        st = _agg.get(name)
        if st is None:
            _agg[name] = [1, elapsed_s, elapsed_s, elapsed_s]
        else:
            st[0] += 1
            st[1] += elapsed_s
            if elapsed_s < st[2]:
                st[2] = elapsed_s
            if elapsed_s > st[3]:
                st[3] = elapsed_s
        if len(_events) < _MAX_EVENTS:
            _events.append((name, now - elapsed_s, elapsed_s,
                            threading.get_ident()))
        elif not _config.get("_events_truncated"):
            _config["_events_truncated"] = True
            _events.append(("<TRACE TRUNCATED: event cap reached>",
                            now, 0.0, threading.get_ident()))
            warn_cap = True
    if warn_cap:  # log OUTSIDE the lock
        import logging
        logging.getLogger(__name__).warning(
            "profiler: chrome-trace event cap (%d) reached; later "
            "scopes are not recorded in the trace", _MAX_EVENTS)


def set_config(**kwargs):
    """``filename`` (the Chrome trace `dump` writes; ``.json`` added when
    missing), ``aggregate_stats`` (op rows in `dumps`), ``profile_all``
    (kept for the reference's API; the session always records CPU ops,
    and the card's kernels when one is visible)."""
    _config.update(kwargs)


def set_state(state="stop", profile_process="worker"):
    """MXNet's switch: ``"run"`` starts a session, ``"stop"`` ends it."""
    if state not in ("run", "stop"):
        raise ValueError(f"profiler state must be 'run' or 'stop', got "
                         f"{state!r}")
    if state == "run":
        start()
    else:
        stop()


def start():
    global _prof
    if _config.get("running"):
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        _prof = torch.profiler.profile(activities=acts)
        _prof.__enter__()
        _config["tracing"] = True
    except Exception:  # a session already running, or a backend quirk
        _prof = None
        _config["tracing"] = False
    _config["running"] = True
    _config["_events_truncated"] = False
    with _agg_lock:
        _events.clear()  # no stale events from a previous session


def stop():
    global _prof
    if not _config.get("running"):
        return
    prof, _prof = _prof, None
    _config["running"] = False
    if prof is None:
        return
    prof.__exit__(None, None, None)
    _config["_trace"] = _trace_events(prof)
    rows = []
    if _config.get("aggregate_stats"):
        for e in prof.key_averages():
            dev = getattr(e, "device_time_total",
                          getattr(e, "cuda_time_total", 0.0))
            rows.append((e.key, int(e.count), e.cpu_time_total / 1e3,
                         dev / 1e3))
    with _agg_lock:
        _op_rows[:] = rows


def _trace_events(prof) -> list:
    """The session's own Chrome events (torch's exporter, read back)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="mxtpu_prof_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = _json.load(f)
        return list(doc.get("traceEvents", doc if isinstance(doc, list)
                            else []))
    except Exception:
        return []
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def _toggle(on: bool) -> None:
    prof = _prof
    if prof is None or not hasattr(prof, "toggle_collection_dynamic"):
        return
    try:
        prof.toggle_collection_dynamic(on, list(prof.activities))
    except Exception:   # a build without dynamic toggling: ops keep coming
        pass


def pause(profile_process="worker"):
    """Stop collecting torch ops (the scopes keep recording).  No-op when
    the profiler is not running."""
    if _config.get("running"):
        _toggle(False)


def resume(profile_process="worker"):
    if _config.get("running"):
        _toggle(True)


def dump(finished=True, profile_process="worker"):
    """Stop (like the reference's finished=True) and write the session's
    Chrome trace plus the user scopes' events to `filename` (parity:
    `src/profiler/profiler.h:87,441` DumpProfile).  Returns the path.
    ``finished=False`` writes the scopes collected so far and keeps the
    session running (torch's events come with the session's end)."""
    if finished and _config.get("running"):
        stop()
    out = _config.get("filename", "profile_output")
    if not out.endswith(".json"):
        out = out + ".json"
    with _agg_lock:
        events = list(_events)
        if finished:
            _events.clear()
    trace = list(_config.get("_trace") or []) if finished else []
    trace += [{"name": name, "ph": "X", "cat": "scope",
               "ts": t0 * 1e6, "dur": dur * 1e6, "pid": os.getpid(),
               "tid": tid} for name, t0, dur, tid in events]
    d = os.path.dirname(os.path.abspath(out))
    os.makedirs(d, exist_ok=True)
    with open(out, "w") as f:
        _json.dump({"traceEvents": trace, "displayTimeUnit": "ms"}, f)
    return out


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """Aggregate stats (parity: `python/mxnet/profiler.py:154` over
    `src/profiler/aggregate_stats.cc`): the user scopes and markers, and
    with ``aggregate_stats=True`` the last session's torch ops.

    format: "table" (reference-style text table) or "json".
    sort_by: one of "total", "avg", "min", "max", "count".
    """
    with _agg_lock:
        rows = [(name, st[0], st[1] * 1e3, st[2] * 1e3, st[3] * 1e3,
                 st[1] * 1e3 / st[0])
                for name, st in _agg.items()]
        ops = list(_op_rows)
        counters = dict(_counters)
        if reset:
            # resets aggregate stats only (reference semantics)
            _agg.clear()
            _counters.clear()
            _op_rows.clear()

    key_idx = {"count": 1, "total": 2, "min": 3, "max": 4, "avg": 5}
    idx = key_idx.get(sort_by, 2)
    rows.sort(key=lambda r: r[idx], reverse=not ascending)
    op_idx = {"count": 1, "total": 2}.get(sort_by, 2)
    ops.sort(key=lambda r: r[op_idx], reverse=not ascending)

    if format == "json":
        return _json.dumps({
            "Time": {name: {"Count": c, "Total": t, "Min": mn, "Max": mx,
                            "Avg": avg}
                     for name, c, t, mn, mx, avg in rows},
            "Ops": {name: {"Count": c, "Host": h, "Device": dv}
                    for name, c, h, dv in ops},
            "Unit": "ms",
            "Counters": counters,
        })

    lines = ["", "Profile Statistics:",
             "\tNote the difference in units for different entries."]
    lines.append("User scopes")
    lines.append("=" * 11)
    hdr = (f"{'Name':<40s} {'Total Count':>12s} {'Time (ms)':>14s} "
           f"{'Min Time (ms)':>14s} {'Max Time (ms)':>14s} "
           f"{'Avg Time (ms)':>14s}")
    lines.append(hdr)
    lines.append(f"{'----':<40s} {'-----------':>12s} {'---------':>14s} "
                 f"{'-------------':>14s} {'-------------':>14s} "
                 f"{'-------------':>14s}")
    for name, c, t, mn, mx, avg in rows:
        lines.append(f"{name[:40]:<40s} {c:>12d} {t:>14.4f} {mn:>14.4f} "
                     f"{mx:>14.4f} {avg:>14.4f}")
    if ops:
        lines.append("")
        lines.append("Operators (last session)")
        lines.append("=" * 24)
        lines.append(f"{'Name':<40s} {'Total Count':>12s} "
                     f"{'Host Time (ms)':>16s} {'Device Time (ms)':>18s}")
        for name, c, h, dv in ops:
            lines.append(f"{name[:40]:<40s} {c:>12d} {h:>16.4f} "
                         f"{dv:>18.4f}")
    if counters:
        lines.append("")
        lines.append("Counters")
        lines.append("=" * 8)
        for name, v in sorted(counters.items()):
            v_str = f"{v:d}" if isinstance(v, int) else f"{v:g}"
            lines.append(f"{name[:40]:<40s} {v_str:>12s}")
    lines.append("")
    return "\n".join(lines)


def state():
    return "RUNNING" if _config.get("running") else "STOPPED"


class scope:
    """Named profiling scope (parity: profiler scopes `profiler.h:772`).

    A ``record_function`` range in the trace and, while the profiler runs,
    a row of the aggregate table.
    """

    def __init__(self, name="<unk>:"):
        self._name = name
        self._t = None
        self._t0 = None

    def __enter__(self):
        import torch
        self._t = torch.profiler.record_function(self._name)
        self._t.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            if _config.get("running"):
                _record_stat(self._name, time.perf_counter() - self._t0)
            self._t0 = None
        self._t.__exit__(*exc)
        return False


class Task(scope):
    def __init__(self, name="task", domain=None):
        super().__init__(name)
        self.start_time = None

    def start(self):
        self.__enter__()

    def stop(self):
        self.__exit__(None, None, None)


Frame = Task
Event = Task


class Counter:
    def __init__(self, name="counter", domain=None, value=0):
        self.name = name
        self.set_value(value)

    def set_value(self, value):
        # recorded unconditionally (not gated on `running`): a counter set
        # before start() would otherwise be silently dropped
        self.value = value
        with _agg_lock:
            _counters[self.name] = value

    def increment(self, delta=1):
        self.set_value(self.value + delta)

    def decrement(self, delta=1):
        self.set_value(self.value - delta)


class Marker:
    def __init__(self, name="marker", domain=None):
        self.name = name

    def mark(self, scope_="process"):
        if _config.get("running"):
            _record_stat(f"marker:{self.name}", 0.0)
