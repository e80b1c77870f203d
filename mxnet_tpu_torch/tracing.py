"""Distributed tracing + FLOP-accounted performance attribution
(counterpart of ``mxnet_tpu/tracing.py``: the same names, environment
variables, span names, gauges and Chrome export).

Two instruments, one module:

* :class:`Tracer` — lightweight spans (trace_id / span_id / parent_id, a
  per-tracer thread-local current-span stack, explicit cross-thread
  context handoff via :meth:`Tracer.current_context`).  Finished spans
  go to the `telemetry.RunJournal` as ``span`` events (when a journal is
  attached) and accumulate in a bounded ring exportable as
  Chrome/Perfetto ``trace_event`` JSON (:func:`export_chrome` — open the
  file in https://ui.perfetto.dev or chrome://tracing).  Instrumentation
  sites: `parallel.TrainStep` (``train.dispatch`` → ``train.compile`` at
  warmup → ``train.device`` until retire, tagged with the journal's step
  ids) and `CheckpointManager` (``checkpoint.save`` /
  ``checkpoint.restore``).

* :class:`CostAccountant` — a per-program registry of cost features.
  JAX reads XLA's ``cost_analysis`` of each compiled executable; the port
  counts a step's FLOPs once, at `TrainStep.warmup`, with
  ``torch.utils.flop_counter.FlopCounterMode`` (:class:`FlopCount`).  That
  counter sees torch's own products (``mm``, ``bmm``, ``addmm``,
  convolutions, SDPA) but not the port's CUDA kernels, so the
  flash-attention wrapper reports its products' FLOPs itself through
  :func:`note_kernel_flops` where it launches (forward: QK^T and PV,
  4·rows·keys·D; backward: the recomputed QK^T and the four gradient
  products, 10·rows·keys·D — what its plain version's matmuls count).  The
  cross-entropy and norm kernels do no products, and neither does the
  counter for their plain versions.  At step retire the flops combine with
  measured wall time into the ``mfu_estimate`` / ``step_flops`` gauges,
  and each ``step_retired`` journal row carries the feature vector.

MFU semantics: on a card the estimate divides by the card's dense peak
for the step's weight dtype (H100: 989 TFLOP/s bf16 and f16, 67 TFLOP/s
f32).  Elsewhere (the CPU) the peak is the **projected** peak of the
configured device kind (``MXTPU_MFU_DEVICE_KIND``, default ``h100``) —
a trajectory proxy, explicitly NOT a CPU utilization number (the entry
carries ``projected=True``).  ``MXTPU_PEAK_TFLOPS`` overrides every peak.

Gating contract (the `telemetry.enabled()` idiom): span creation sites
guard on one module-level bool (:func:`enabled` — ``MXTPU_TRACE``), so
a run without tracing pays one boolean read and ZERO allocations per
step.
"""
from __future__ import annotations

import atexit
import collections
import itertools
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import telemetry as _tele

__all__ = [
    "Span", "SpanContext", "Tracer", "CostAccountant", "ClockSync",
    "enabled", "enable", "disable", "get_tracer", "tracers", "span",
    "trace_dir", "export_chrome", "chrome_events", "reset",
    "span_to_wire", "note_remote_process", "remote_processes",
    "account", "record_executable", "cost_features_of", "estimate_mfu",
    "peak_flops", "projected_peak_flops", "note_step_cost",
    "FlopCount", "note_kernel_flops",
    "ENV_TRACE", "ENV_TRACE_DIR", "ENV_MFU_KIND", "ENV_PEAK_TFLOPS",
]

_log = logging.getLogger(__name__)

ENV_TRACE = "MXTPU_TRACE"
ENV_TRACE_DIR = "MXTPU_TRACE_DIR"
ENV_MFU_KIND = "MXTPU_MFU_DEVICE_KIND"
ENV_PEAK_TFLOPS = "MXTPU_PEAK_TFLOPS"

# spans kept per tracer for export (oldest dropped); a multi-hour run
# with tracing left on must stay bounded in host memory
DEFAULT_SPAN_CAP = 200_000

# ts anchor: chrome trace_event wants wall-clock microseconds, span
# timing wants a monotonic clock — record the pair once and convert
_EPOCH_WALL = time.time()
_EPOCH_PERF = time.perf_counter()

# span-id allocation is salted by pid so spans SHIPPED from a worker
# process into the parent's trace tree (Tracer.ingest) can never
# collide with the parent's own ids — parent_id links must stay
# unambiguous within one trace
_SPAN_ID_BASE = (os.getpid() & 0xFFFFF) << 32


def _wall_us(t_perf: float) -> float:
    return (_EPOCH_WALL + (t_perf - _EPOCH_PERF)) * 1e6


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class SpanContext:
    """The portable identity of a span: what another thread needs to
    parent its own spans under it (`Tracer.current_context` →
    ``span(..., parent=ctx)``)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: int):
        self.trace_id = trace_id
        self.span_id = int(span_id)

    def __repr__(self):
        return f"SpanContext({self.trace_id}, {self.span_id})"


class Span:
    """One timed operation.  Usable as a context manager (lexical spans)
    or via explicit :meth:`finish` (request-lifecycle spans that outlive
    any single call frame)."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "t0", "t1", "tags", "track", "pid", "_on_stack")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: int, parent_id: Optional[int],
                 track: Optional[str], tags: Dict[str, object],
                 t0: Optional[float] = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.track = track
        self.tags = tags
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1: Optional[float] = None
        self.pid: Optional[int] = None  # None = this process; set on ingest
        self._on_stack = False

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    @property
    def duration_ms(self) -> Optional[float]:
        if self.t1 is None:
            return None
        return (self.t1 - self.t0) * 1e3

    def finish(self, t1: Optional[float] = None, **tags) -> "Span":
        """Close the span (idempotent).  Extra `tags` merge in; manual
        spans pass nothing, post-hoc recorders pass an explicit `t1`."""
        if self.t1 is not None:
            return self
        if tags:
            self.tags.update(tags)
        self.t1 = time.perf_counter() if t1 is None else t1
        self.tracer._finish(self)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.tags.setdefault("error", exc_type.__name__)
        if self._on_stack:
            self.tracer._pop(self)
        self.finish()
        return False

    def __repr__(self):
        state = "open" if self.t1 is None else f"{self.duration_ms:.3f}ms"
        return (f"Span({self.name}, trace={self.trace_id}, "
                f"id={self.span_id}, parent={self.parent_id}, {state})")


class Tracer:
    """One span namespace (e.g. ``train``, ``checkpoint``).

    Each tracer owns its OWN trace-id space and its OWN thread-local
    current-span stack, so two subsystems tracing concurrently in one
    process can never contaminate each other's traces (the trace_id
    carries the tracer name).  Root spans (no
    parent on the stack, no explicit parent) open a fresh trace_id;
    children inherit the parent's."""

    def __init__(self, name: str, span_cap: int = DEFAULT_SPAN_CAP):
        self.name = name
        self._span_ids = itertools.count(_SPAN_ID_BASE + 1)
        self._trace_ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        # deque(maxlen): O(1) eviction at the cap — a list.pop(0) would
        # shift 200k entries under the lock on every finish once full
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=int(span_cap))
        self._span_cap = int(span_cap)
        self.dropped = 0

    # -- stack ----------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        """The innermost open span on THIS thread (or None)."""
        st = self._stack()
        return st[-1] if st else None

    def current_context(self) -> Optional[SpanContext]:
        """Cross-thread handoff: capture on the owning thread, pass the
        context to the worker, parent its spans with ``parent=ctx``."""
        cur = self.current()
        return cur.context() if cur is not None else None

    def _new_trace_id(self) -> str:
        return f"{self.name}-{os.getpid():x}-{next(self._trace_ids):x}"

    def _ids_for(self, parent) -> Tuple[str, Optional[int]]:
        """(trace_id, parent_id) from an explicit parent (Span /
        SpanContext), the thread-local stack, or a fresh root."""
        if parent is not None:  # Span and SpanContext share the fields
            return parent.trace_id, parent.span_id
        cur = self.current()
        if cur is not None:
            return cur.trace_id, cur.span_id
        return self._new_trace_id(), None

    # -- span creation --------------------------------------------------
    def span(self, name: str, parent=None, track: Optional[str] = None,
             **tags) -> Span:
        """Lexical span: ``with tracer.span("phase"): ...`` — pushed on
        the thread-local stack, so nested ``span()`` calls on the same
        thread parent automatically."""
        s = self.start_span(name, parent=parent, track=track, **tags)
        s._on_stack = True
        self._stack().append(s)
        return s

    def start_span(self, name: str, parent=None,
                   track: Optional[str] = None, **tags) -> Span:
        """Manual span: NOT pushed on the stack (finish() explicitly).
        For operations that outlive the creating call frame — a serve
        request, an in-flight train step."""
        trace_id, parent_id = self._ids_for(parent)
        return Span(self, name, trace_id, next(self._span_ids),
                    parent_id, track, dict(tags))

    def record_span(self, name: str, t0: float, t1: float, parent=None,
                    track: Optional[str] = None, **tags) -> Span:
        """Post-hoc span from already-measured perf_counter endpoints
        (per-slot serve phases reconstructed after the fused step ran)."""
        trace_id, parent_id = self._ids_for(parent)
        s = Span(self, name, trace_id, next(self._span_ids), parent_id,
                 track, dict(tags), t0=t0)
        s.finish(t1=t1)
        return s

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:            # exited out of order: drop through it
            st.remove(span)

    def _finish(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._span_cap:
                self.dropped += 1      # deque maxlen evicts the oldest
            self._spans.append(span)
        if _tele.enabled():
            # a `step` tag intentionally lands as the journal row's step
            # id, correlating the span with step_dispatched/retired rows
            _tele.event("span", span=span.name, tracer=self.name,
                        trace_id=span.trace_id, span_id=span.span_id,
                        parent_id=span.parent_id,
                        dur_ms=round(span.duration_ms, 3),
                        **{k: v for k, v in span.tags.items()
                           if k not in ("span", "tracer", "trace_id",
                                        "span_id", "parent_id", "dur_ms")})

    # -- introspection / export -----------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
        self.dropped = 0

    def drain(self) -> List[Span]:
        """Pop every finished span out of the ring (worker processes
        drain on each heartbeat and ship the batch to the parent, so
        the same span is never sent twice)."""
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
        return out

    def ingest(self, rows: List[dict], offset: float = 0.0,
               pid: Optional[int] = None,
               replica: Optional[str] = None) -> int:
        """Adopt finished spans shipped from another process
        (:func:`span_to_wire` dicts).  `offset` is the remote clock's
        perf_counter offset relative to ours (``ClockSync.offset``):
        remote timestamps are rebased by subtracting it, so the adopted
        spans land on THIS process's timeline.  Keeps the remote
        trace/span/parent ids verbatim — that is what stitches the
        cross-process tree together."""
        n = 0
        for row in rows:
            try:
                tags = dict(row.get("tags") or {})
                if replica is not None:
                    tags.setdefault("replica", replica)
                s = Span(self, str(row["name"]), str(row["trace_id"]),
                         int(row["span_id"]),
                         (int(row["parent_id"])
                          if row.get("parent_id") is not None else None),
                         row.get("track"), tags,
                         t0=float(row["t0"]) - offset)
                s.pid = int(pid) if pid is not None else None
                s.finish(t1=float(row["t1"]) - offset)
                n += 1
            except (AttributeError, KeyError, TypeError, ValueError):
                continue   # one malformed row must not drop the batch
        return n


def span_to_wire(s: Span) -> dict:
    """One finished span as a JSON-safe dict for the events channel
    (the inverse of :meth:`Tracer.ingest`).  Timestamps stay in the
    SENDER's perf_counter domain — the receiver rebases with its
    ClockSync offset for this peer."""
    return {"name": s.name, "trace_id": s.trace_id,
            "span_id": s.span_id, "parent_id": s.parent_id,
            "track": s.track, "t0": s.t0, "t1": s.t1,
            "tags": _tele.json_safe(s.tags)}


class ClockSync:
    """NTP-style offset estimator between this process's perf_counter
    and a peer's.

    Each :meth:`update` sample is one request/response round trip:
    ``offset = remote_ts - (t_send + t_recv) / 2`` — the RTT-halving
    assumption (symmetric paths).  The estimate served is the offset of
    the MINIMUM-RTT sample in a sliding window: low-RTT exchanges bound
    the asymmetry error tightest, and the window lets the estimate
    track drift as old samples age out.  ``rebase`` maps a remote
    timestamp onto the local timeline."""

    __slots__ = ("_window", "offset", "rtt", "samples")

    def __init__(self, window: int = 8):
        self._window: "collections.deque[Tuple[float, float]]" = \
            collections.deque(maxlen=int(window))
        self.offset = 0.0
        self.rtt: Optional[float] = None
        self.samples = 0

    def seed(self, offset: float) -> None:
        """Coarse one-way estimate (the hello handshake timestamp,
        unknown RTT).  Only used until the first real round-trip
        sample — a one-way sample has no RTT bound, so it must never
        outcompete measured ones in the min-RTT selection."""
        if self.samples == 0:
            self.offset = float(offset)

    def update(self, t_send: float, remote_ts: float,
               t_recv: float) -> float:
        rtt = max(0.0, float(t_recv) - float(t_send))
        off = float(remote_ts) - (float(t_send) + float(t_recv)) / 2.0
        self._window.append((rtt, off))
        self.samples += 1
        self.rtt, self.offset = min(self._window, key=lambda s: s[0])
        return self.offset

    def rebase(self, remote_t: float) -> float:
        """A remote perf_counter timestamp on the local timeline."""
        return float(remote_t) - self.offset

    def __repr__(self):
        rtt = "?" if self.rtt is None else f"{self.rtt * 1e3:.3f}ms"
        return (f"ClockSync(offset={self.offset * 1e3:.3f}ms, "
                f"rtt={rtt}, samples={self.samples})")


# ---------------------------------------------------------------------------
# module-level tracer registry + enable gate
# ---------------------------------------------------------------------------

_enabled = False
_trace_dir: Optional[str] = None
_tracers: Dict[str, Tracer] = {}
_remote_procs: Dict[int, str] = {}
_reg_lock = threading.Lock()
_atexit_registered = False


def note_remote_process(pid: Optional[int], name: str) -> None:
    """Name a remote pid whose spans this process ingests — becomes a
    ``process_name`` metadata row in the Perfetto export, so worker
    tracks render under "worker d1" instead of a bare pid."""
    if pid is not None:
        with _reg_lock:
            _remote_procs[int(pid)] = str(name)


def remote_processes() -> Dict[int, str]:
    with _reg_lock:
        return dict(_remote_procs)


def enabled() -> bool:
    """One global read — the zero-cost fast path every span site guards
    on (`MXTPU_TRACE`)."""
    return _enabled


def get_tracer(name: str) -> Tracer:
    """Get-or-create the named tracer (instrumentation sites call this
    once and cache, or call per use — it is a dict lookup)."""
    t = _tracers.get(name)
    if t is None:
        with _reg_lock:
            t = _tracers.get(name)
            if t is None:
                t = _tracers[name] = Tracer(name)
    return t


def tracers() -> Dict[str, Tracer]:
    return dict(_tracers)


def span(name: str, tracer: str = "run", **tags) -> Span:
    """Module facade: a lexical span on the named tracer."""
    return get_tracer(tracer).span(name, **tags)


def trace_dir() -> Optional[str]:
    return _trace_dir


def enable(dir: Optional[str] = None) -> None:
    """Turn span collection on; `dir` (or ``MXTPU_TRACE_DIR``) is where
    :func:`export_chrome` writes by default, and where the atexit hook
    auto-exports when the env enabled tracing."""
    global _enabled, _trace_dir, _atexit_registered
    if dir is not None:
        _trace_dir = os.path.abspath(dir)
    elif _trace_dir is None:
        env_dir = os.environ.get(ENV_TRACE_DIR, "").strip()
        if env_dir:
            _trace_dir = os.path.abspath(env_dir)
    _enabled = True
    if not _atexit_registered:
        atexit.register(_atexit_export)
        _atexit_registered = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop every tracer and collected span (tests)."""
    global _trace_dir
    with _reg_lock:
        _tracers.clear()
        _remote_procs.clear()
    _trace_dir = None


def _atexit_export() -> None:
    if not _enabled or _trace_dir is None:
        return
    try:
        if any(t.spans() for t in _tracers.values()):
            export_chrome()
    except Exception:   # export-at-exit must never mask the real exit
        _log.debug("tracing atexit export failed", exc_info=True)


# ---------------------------------------------------------------------------
# Chrome/Perfetto trace_event export
# ---------------------------------------------------------------------------

def chrome_events(include: Optional[List[str]] = None,
                  since: Optional[float] = None) -> List[dict]:
    """All finished spans as Chrome ``trace_event`` dicts.
    ``since`` (a ``time.perf_counter`` instant) keeps only spans that
    were still open at or after it — bounded exports.

    Every span becomes a complete ``"ph": "X"`` event.  Tracks: spans
    carry either an explicit ``track`` (``train host``, ``train
    device``, ``checkpoint``) or their tracer's name; each (process, track) pair gets a synthetic tid plus
    an ``"M"`` thread_name metadata event naming it.  Spans ingested
    from worker processes keep their origin pid, and every remote pid
    named via :func:`note_remote_process` gets a ``process_name``
    metadata row."""
    local_pid = os.getpid()
    events: List[dict] = []
    track_tids: Dict[Tuple[int, str], int] = {}
    next_tid = itertools.count(1)

    def tid_for(pid: int, track: str) -> int:
        t = track_tids.get((pid, track))
        if t is None:
            t = track_tids[(pid, track)] = next(next_tid)
        return t

    names = include if include is not None else sorted(_tracers)
    for tname in names:
        tracer = _tracers.get(tname)
        if tracer is None:
            continue
        for s in tracer.spans():
            if s.t1 is None:
                continue
            if since is not None and s.t1 < since:
                continue
            spid = s.pid if s.pid is not None else local_pid
            track = s.track if s.track is not None else f"{tname}"
            args = {"trace_id": s.trace_id, "span_id": s.span_id}
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            args.update(_tele.json_safe(s.tags))
            events.append({
                "name": s.name, "ph": "X", "cat": tname,
                "ts": round(_wall_us(s.t0), 3),
                "dur": round((s.t1 - s.t0) * 1e6, 3),
                "pid": spid, "tid": tid_for(spid, track), "args": args,
            })
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": track}}
            for (pid, track), tid in sorted(track_tids.items(),
                                            key=lambda kv: kv[1])]
    remote = remote_processes()
    seen_pids = {pid for pid, _ in track_tids}
    if remote and seen_pids - {local_pid}:
        # merged multi-process export: name every process group
        meta += [{"name": "process_name", "ph": "M", "pid": local_pid,
                  "args": {"name": f"parent {local_pid}"}}]
        meta += [{"name": "process_name", "ph": "M", "pid": pid,
                  "args": {"name": pname}}
                 for pid, pname in sorted(remote.items())
                 if pid in seen_pids]
    # stable render order: metadata first, then spans by start time
    events.sort(key=lambda e: e["ts"])
    return meta + events


def export_chrome(path: Optional[str] = None,
                  since: Optional[float] = None) -> str:
    """Write the collected spans as a Chrome/Perfetto-loadable JSON
    trace; returns the path (default:
    ``<trace_dir>/trace_<pid>.json``).  ``since`` bounds the export to
    spans still open at/after that ``perf_counter`` instant."""
    if path is None:
        d = _trace_dir or os.getcwd()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"trace_{os.getpid()}.json")
    else:
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
    doc = {"traceEvents": chrome_events(since=since),
           "displayTimeUnit": "ms",
           "otherData": {"exporter": "mxnet_tpu_torch.tracing",
                         "pid": os.getpid()}}
    with open(path, "w") as f:
        json.dump(doc, f)
    if _tele.enabled():
        _tele.event("trace_export", path=path,
                    spans=len(doc["traceEvents"]))
    return path


# ---------------------------------------------------------------------------
# cost accounting
# ---------------------------------------------------------------------------

# dense peak flops of the cards the port runs on, by weight dtype (the
# chip smoke's `PEAK` table, shared so the MFU gauge and the smoke agree
# on the denominator); only the cards the port targets are listed.
_PEAK_FLOPS = (
    ("h100", {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}),
)
_DEFAULT_KIND = "h100"


def _dtype_key(dtype) -> str:
    name = str(dtype or "bfloat16").replace("torch.", "")
    return {"bf16": "bfloat16", "half": "float16", "f16": "float16",
            "float": "float32", "f32": "float32"}.get(name, name)


def peak_flops(device_kind: str, dtype="bfloat16") -> float:
    """Dense peak FLOP/s of a device kind for `dtype` (bf16 when not
    given; unknown kinds and dtypes take the H100's bf16 peak);
    ``MXTPU_PEAK_TFLOPS`` overrides everything."""
    env = os.environ.get(ENV_PEAK_TFLOPS, "").strip()
    if env:
        try:
            return float(env) * 1e12
        except ValueError:
            _log.warning("ignoring non-numeric %s=%r", ENV_PEAK_TFLOPS, env)
    kind = (device_kind or "").lower()
    table = dict(_PEAK_FLOPS)[_DEFAULT_KIND]
    for key, val in _PEAK_FLOPS:
        if key in kind:
            table = val
            break
    return table.get(_dtype_key(dtype), table["bfloat16"])


def projected_peak_flops(dtype="bfloat16") -> Tuple[float, str]:
    """(peak_flops, kind) for MFU **projection** off the card: the
    device kind the run is being sized for (``MXTPU_MFU_DEVICE_KIND``,
    default ``h100``)."""
    kind = os.environ.get(ENV_MFU_KIND, _DEFAULT_KIND).strip() \
        or _DEFAULT_KIND
    return peak_flops(kind, dtype), kind


def estimate_mfu(flops, measured_s: float, device=None,
                 dtype="bfloat16") -> Optional[dict]:
    """MFU of `flops` executed in `measured_s` wall seconds on `device`
    (a ``torch.device`` or its string; default: card 0 when one is
    visible).  On a card: the peak of its kind (``get_device_name``) for
    `dtype`; anything else: the PROJECTED peak of the configured kind
    (``MXTPU_MFU_DEVICE_KIND``) with ``projected=True`` — a trajectory
    proxy, never a CPU utilization claim."""
    if not flops or measured_s is None or measured_s <= 0:
        return None
    kind = None
    try:
        import torch
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)
        if device.type == "cuda" and torch.cuda.is_available():
            kind = torch.cuda.get_device_name(device)
    except Exception:
        kind = None
    if kind is not None:
        peak, projected = peak_flops(kind, dtype), False
    else:
        (peak, kind), projected = projected_peak_flops(dtype), True
    achieved = float(flops) / measured_s
    return {"mfu_estimate": achieved / peak,
            "achieved_flops_per_s": achieved,
            "peak_flops": peak, "projected": projected,
            "device_kind": kind}


# ---------------------------------------------------------------------------
# FLOP counting (the port's stand-in for XLA's cost_analysis)
# ---------------------------------------------------------------------------

_kernel_sinks: List[Dict[str, float]] = []


def note_kernel_flops(name: str, flops: float) -> None:
    """A hand-written kernel's launch reports the FLOPs of its products
    (``FlopCounterMode`` cannot see into it).  A no-op unless a
    :class:`FlopCount` is open."""
    if _kernel_sinks:
        sink = _kernel_sinks[-1]
        sink[name] = sink.get(name, 0.0) + float(flops)


class FlopCount:
    """Context manager counting the FLOPs of the work run inside it:
    torch's products through ``torch.utils.flop_counter.FlopCounterMode``,
    the port's kernels through :func:`note_kernel_flops`.  After exit,
    :meth:`features` is the cost-feature dict `CostAccountant.record`
    takes (``flops`` = both; ``torch_flops``, ``kernel_flops`` and
    ``kernel_flops_by_op`` apart; ``hbm_bytes_est`` the card's peak
    allocation inside the block when it ran on one)."""

    def __init__(self, device=None):
        self.device = device
        self._mode = None
        self._sink: Dict[str, float] = {}
        self.torch_flops = 0.0
        self.peak_bytes: Optional[float] = None

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        import torch
        self._cuda = (self.device is not None
                      and torch.device(self.device).type == "cuda")
        if self._cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self._mode = FlopCounterMode(display=False)
        self._mode.__enter__()
        _kernel_sinks.append(self._sink)
        return self

    def __exit__(self, *exc):
        try:
            _kernel_sinks.remove(self._sink)
        except ValueError:
            pass
        self._mode.__exit__(*exc)
        self.torch_flops = float(self._mode.get_total_flops())
        if self._cuda:
            import torch
            self.peak_bytes = float(torch.cuda.max_memory_allocated(
                self.device))
        return False

    def features(self) -> dict:
        kernel = sum(self._sink.values())
        out = {"flops": self.torch_flops + kernel,
               "torch_flops": self.torch_flops,
               "kernel_flops": kernel,
               "kernel_flops_by_op": dict(self._sink)}
        if self.peak_bytes:
            out["hbm_bytes_est"] = self.peak_bytes
        return out


def cost_features_of(counted) -> Optional[dict]:
    """Normalize one counted program into a flat feature dict: a finished
    :class:`FlopCount`, or a dict of features.  Returns None for anything
    else — callers treat that as "no attribution", never an error."""
    if isinstance(counted, FlopCount):
        return counted.features()
    if isinstance(counted, dict):
        return dict(counted) or None
    return None


class CostAccountant:
    """Registry of per-program cost features keyed by a stable name
    (``train_step@<id>``, ``autotune/<op>/<key>`` ...).

    `record` is called once per counted program (`TrainStep.warmup` hands
    it the finished :class:`FlopCount`), so lookups at step retire are
    one dict read.  `mfu` combines an entry's flops with a measured wall
    time and the device peak for the entry's ``dtype`` (projected peak
    off the card)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {}

    def record(self, key: str, compiled, **meta) -> Optional[dict]:
        feats = cost_features_of(compiled)
        if feats is None:
            return None
        return self.record_features(key, feats, **meta)

    def record_features(self, key: str, features: dict,
                        **meta) -> dict:
        """Register a pre-computed feature dict (the autotuner's
        analytic roofline for its kernel trials; everything else goes
        through `record`)."""
        entry = {"key": key, "features": dict(features),
                 "meta": dict(meta)}
        with self._lock:
            self._entries[key] = entry
        if _tele.enabled():
            _tele.event("cost_analysis", key=key,
                        flops=features.get("flops"),
                        bytes_accessed=features.get("bytes_accessed"),
                        hbm_bytes_est=features.get("hbm_bytes_est"),
                        **meta)
        return entry

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            return self._entries.get(key)

    def features(self, key: str) -> Optional[dict]:
        e = self.get(key)
        return dict(e["features"]) if e else None

    def entries(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def discard(self, key: str) -> None:
        """Drop one entry (the next count re-records)."""
        with self._lock:
            self._entries.pop(key, None)

    def mfu(self, key: str, measured_s: float,
            device=None) -> Optional[dict]:
        """MFU estimate for one execution of `key` taking `measured_s`
        wall seconds: ``{"mfu_estimate", "achieved_flops_per_s",
        "peak_flops", "projected", "device_kind"}`` (None when the key
        has no flops or the measurement is degenerate)."""
        e = self.get(key)
        if e is None:
            return None
        meta = e["meta"]
        return estimate_mfu(e["features"].get("flops"), measured_s,
                            device=meta.get("device") if device is None
                            else device,
                            dtype=meta.get("dtype", "bfloat16"))


_account = CostAccountant()


def account() -> CostAccountant:
    """The process-wide cost registry."""
    return _account


def record_executable(key: str, compiled, **meta) -> Optional[dict]:
    """Facade over ``account().record`` — what the counting sites call.
    Never raises: attribution must not take a warmup down."""
    try:
        return _account.record(key, compiled, **meta)
    except Exception:
        _log.debug("cost capture failed for %s", key, exc_info=True)
        return None


def note_step_cost(key: str, measured_s: float,
                   device=None) -> Optional[dict]:
    """Combine one retired execution's measured wall time with its
    executable's recorded cost: updates the always-on ``mfu_estimate`` /
    ``step_flops`` / ``hbm_bytes_est`` gauges (when telemetry is
    enabled) and returns the cost-feature row for the caller to embed
    in its journal record.  One dict lookup + arithmetic — cheap enough
    for every retire."""
    e = _account.get(key)
    if e is None:
        return None
    feats = e["features"]
    mfu = _account.mfu(key, measured_s, device=device)
    row = {"measured_ms": round(measured_s * 1e3, 3)}
    if feats.get("flops"):
        row["flops"] = feats["flops"]
    if feats.get("bytes_accessed"):
        row["bytes_accessed"] = feats["bytes_accessed"]
    if feats.get("hbm_bytes_est"):
        row["hbm_bytes_est"] = feats["hbm_bytes_est"]
    if mfu is not None:
        # full precision: a tiny CPU proxy model's MFU is ~1e-9 and must
        # stay NONZERO (it is a trajectory number, not a pretty one)
        row["mfu_estimate"] = mfu["mfu_estimate"]
        row["mfu_projected"] = mfu["projected"]
    if _tele.enabled():
        # per-program label: a process serving AND training must not
        # have the two executables overwrite each other's gauges
        program = e["meta"].get("kind", "unknown")
        if mfu is not None:
            _tele.gauge(
                "mfu_estimate",
                "Model-flops utilization of the last retired step "
                "(counted flops / wall / device peak; PROJECTED peak "
                "off the card)",
                labelnames=("program",)).set(mfu["mfu_estimate"],
                                             program=program)
        if feats.get("flops"):
            _tele.gauge(
                "step_flops",
                "Counted flops of the executing step program",
                labelnames=("program",)).set(feats["flops"],
                                             program=program)
        if feats.get("hbm_bytes_est"):
            _tele.gauge(
                "hbm_bytes_est",
                "Peak device bytes allocated while the step was "
                "counted",
                labelnames=("program",)).set(feats["hbm_bytes_est"],
                                             program=program)
    return row


# auto-enable from the environment: MXTPU_TRACE=1 (or a path value,
# which doubles as the trace dir).  Same child-process rule as
# telemetry: spawned workers stay dark.
_env = os.environ.get(ENV_TRACE, "").strip()
if _env and _env.lower() not in ("0", "false", "no", "off") \
        and not _tele._in_child_process():
    _is_path = os.sep in _env
    enable(dir=_env if _is_path else None)
del _env
