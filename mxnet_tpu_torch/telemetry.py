"""Unified runtime telemetry: metrics registry, device-memory monitor, and a
structured training-run journal (counterpart of ``mxnet_tpu/telemetry.py``:
the same names, environment variables, metric names, event names and
journal format).

The reference's engine profiler + aggregate-stats table (`src/profiler/`)
gave operators one place to see what the runtime was doing.  This module is
that place for the port: a process-wide, thread-safe
:class:`MetricsRegistry` of labeled :class:`Counter`/:class:`Gauge`/
:class:`Histogram` primitives (ms-oriented fixed buckets), exportable as a
plain dict (`snapshot()`), Prometheus text exposition, or JSON — optionally
served from a stdlib ``http.server`` thread (``MXTPU_METRICS_PORT``).  A
:class:`MemoryMonitor` samples each visible card's allocator
(``torch.cuda.memory_stats``: bytes held by live tensors and bytes
reserved) and host RSS into gauges.  A :class:`RunJournal`
writes structured JSONL events (step dispatched/retired, retrace, compile
start/end, checkpoint write/restore/quarantine, worker death/respawn, fault
triggers) with monotonic step ids, so journal rows correlate with
`profiler.step_annotation` ranges in a `torch.profiler` trace.

Gating contract: the registry and journal classes always work when used
directly, but the framework's *instrumentation sites* (`TrainStep`,
`CheckpointManager`, the fault registry, the autotuner, the health
monitor) all guard on :func:`enabled` — one module-level
bool read — so a run without telemetry pays nothing.  Enable with
``MXTPU_TELEMETRY=1`` (or ``=<path.jsonl>`` to also open a journal there),
or programmatically via :func:`enable`.

This module imports only the stdlib at import time (torch is pulled lazily
by the memory monitor).
"""
from __future__ import annotations

import atexit
import json
import logging
import math
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MemoryMonitor",
    "RunJournal", "MetricsServer", "registry", "counter", "gauge",
    "histogram", "enabled", "enable", "disable", "event", "journal",
    "add_event_tap", "remove_event_tap", "json_safe",
    "snapshot", "to_prometheus", "to_json", "serve_metrics",
    "install_compile_cache_listener", "DEFAULT_MS_BUCKETS",
    "ENV_ENABLE", "ENV_PORT", "ENV_MEMMON",
]

_log = logging.getLogger(__name__)

ENV_ENABLE = "MXTPU_TELEMETRY"
ENV_PORT = "MXTPU_METRICS_PORT"
ENV_MEMMON = "MXTPU_MEMMON_INTERVAL"

# histogram defaults are millisecond-oriented: sub-ms dispatch latencies up
# through multi-minute kernel builds all land in a meaningful bucket
DEFAULT_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 30000.0, 60000.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


# ---------------------------------------------------------------------------
# metric primitives
# ---------------------------------------------------------------------------

class _Metric:
    """Base: name + help + fixed label names; per-metric lock (updates may
    come from the training loop, a checkpoint writer thread and the memory
    monitor concurrently)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} for {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def remove(self, **labels) -> bool:
        """Drop one labeled series (True if it existed).  For gauges
        describing a RETIRED entity — a dead fleet replica's queue-depth
        series must not report its last value on /metrics forever.
        Counters are cumulative history and should normally be kept."""
        key = self._key(labels)
        with self._lock:
            return self._values.pop(key, None) is not None


class Counter(_Metric):
    """Monotonically increasing count (events, retries, cache hits)."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc({amount}))")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def _series(self):
        with self._lock:
            return [(dict(zip(self.labelnames, k)), v)
                    for k, v in sorted(self._values.items())]


class Gauge(_Metric):
    """Point-in-time value (steps in flight, occupancy, live bytes)."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def _series(self):
        with self._lock:
            return [(dict(zip(self.labelnames, k)), v)
                    for k, v in sorted(self._values.items())]


class Histogram(_Metric):
    """Fixed-bucket distribution (latencies in ms). Buckets are cumulative
    upper bounds, Prometheus-style; an implicit +Inf bucket is always
    appended, so `observe` never drops a sample."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = _normalize_buckets(name, buckets)
        # key -> [per-bucket counts (non-cumulative), sum, count]
        self._values: Dict[Tuple[str, ...], list] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        value = float(value)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = self._values[key] = [[0] * len(self.buckets), 0.0, 0]
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    st[0][i] += 1
                    break
            st[1] += value
            st[2] += 1

    def count(self, **labels) -> int:
        with self._lock:
            st = self._values.get(self._key(labels))
            return st[2] if st else 0

    def sum(self, **labels) -> float:
        with self._lock:
            st = self._values.get(self._key(labels))
            return st[1] if st else 0.0

    def _series(self):
        """[(labels, {"buckets": {le: cumulative}, "sum": s, "count": n})]"""
        with self._lock:
            out = []
            for k, (counts, total, n) in sorted(self._values.items()):
                cum, acc = {}, 0
                for ub, c in zip(self.buckets, counts):
                    acc += c
                    cum[_fmt_le(ub)] = acc
                out.append((dict(zip(self.labelnames, k)),
                            {"buckets": cum, "sum": total, "count": n}))
            return out


def _normalize_buckets(name: str, buckets: Sequence[float]) -> tuple:
    """Validate + canonicalize histogram buckets: strictly increasing
    finite upper bounds (an unordered list is a caller bug that would
    silently misroute samples, not something to quietly sort away), with
    the implicit +Inf bucket appended."""
    bs = [float(b) for b in buckets]
    if not bs:
        raise ValueError(f"histogram {name} needs at least one bucket")
    if any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
        raise ValueError(
            f"histogram {name}: buckets must be strictly increasing, "
            f"got {tuple(buckets)}")
    if bs[-1] != float("inf"):
        bs.append(float("inf"))
    return tuple(bs)


def _fmt_le(ub: float) -> str:
    if ub == float("inf"):
        return "+Inf"
    return repr(ub) if ub != int(ub) else str(int(ub))


def _escape_label(v: str) -> str:
    """Label-value escaping per the text exposition format: backslash,
    double-quote, and newline (in that order — escaping the escapes
    first)."""
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _escape_help(v: str) -> str:
    """HELP-text escaping: only backslash and newline (quotes are legal
    verbatim in help text, unlike label values)."""
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _labels_str(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(str(v))}"' for k, v in labels.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Process-wide, thread-safe metric registry.

    `counter`/`gauge`/`histogram` are get-or-create: instrumentation sites
    call them on the hot path with just the name and get the same object
    back every time (a kind mismatch raises — two subsystems silently
    sharing one name as different types would corrupt both)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], dict]] = []
        self._lock = threading.RLock()

    # -- collectors -----------------------------------------------------
    def add_collector(self, fn: Callable[[], dict]) -> None:
        """Register a snapshot-shaped series source merged into every
        export (`snapshot`/`to_prometheus`/`to_json`).  `fn` returns
        ``{name: {type, help, series: [...]}}`` — the serve fleet uses
        this to federate worker registries onto the parent's /metrics
        as per-replica-labeled series."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def remove_collector(self, fn: Callable[[], dict]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested {cls.kind}")
                return m
            m = cls(name, help=help, labelnames=labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """Get-or-create a histogram.  `buckets=None` (hot-path callers)
        means "whatever the metric has" — defaults to
        :data:`DEFAULT_MS_BUCKETS` on first creation.  An EXPLICIT
        `buckets=` that conflicts with an already-registered histogram's
        buckets raises: two sites silently disagreeing on bucket bounds
        would make one of them misread every exposition."""
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, Histogram):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested histogram")
                if buckets is not None and \
                        _normalize_buckets(name, buckets) != m.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {m.buckets}, re-requested with "
                        f"{tuple(buckets)}")
                return m
            m = Histogram(name, help=help, labelnames=labelnames,
                          buckets=DEFAULT_MS_BUCKETS if buckets is None
                          else buckets)
            self._metrics[name] = m
            return m

    def get(self, name) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def __contains__(self, name) -> bool:
        return self.get(name) is not None

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every metric (tests; a long-lived process keeps its
        registry for the run's lifetime)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()

    # -- export ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-dict view: {name: {type, help, series: [...]}}; histogram
        series carry cumulative bucket counts + sum + count.  Collector
        series merge in after the local metrics (same name + same type
        extends the series list; a kind clash drops the collector's
        entry — never the local one)."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        out = {}
        for m in metrics:
            series = []
            for labels, val in m._series():
                entry = {"labels": labels}
                if isinstance(val, dict):
                    entry.update(val)
                else:
                    entry["value"] = val
                series.append(entry)
            out[m.name] = {"type": m.kind, "help": m.help, "series": series}
        # collectors run OUTSIDE the registry lock (they take their own)
        for fn in collectors:
            try:
                extra = fn() or {}
            except Exception:
                _log.debug("metrics collector failed", exc_info=True)
                continue
            for name, fm in extra.items():
                series = [dict(s) for s in fm.get("series", ())]
                dst = out.get(name)
                if dst is None:
                    out[name] = {"type": fm.get("type", "gauge"),
                                 "help": fm.get("help", ""),
                                 "series": series}
                elif dst["type"] == fm.get("type"):
                    dst["series"].extend(series)
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps({"time": time.time(),
                           "metrics": self.snapshot()}, indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) — rendered from
        :meth:`snapshot`, so federated collector series are included."""
        lines = []
        for name, m in self.snapshot().items():
            if m.get("help"):
                lines.append(f"# HELP {name} {_escape_help(m['help'])}")
            lines.append(f"# TYPE {name} {m['type']}")
            for entry in m["series"]:
                labels = entry.get("labels") or {}
                if m["type"] == "histogram":
                    for le, c in (entry.get("buckets") or {}).items():
                        lines.append(
                            f"{name}_bucket"
                            f"{_labels_str(labels, f'le={json.dumps(le)}')}"
                            f" {c}")
                    ls = _labels_str(labels)
                    lines.append(
                        f"{name}_sum{ls} {_fmt_val(entry.get('sum', 0))}")
                    lines.append(
                        f"{name}_count{ls} {int(entry.get('count', 0))}")
                else:
                    lines.append(
                        f"{name}{_labels_str(labels)} "
                        f"{_fmt_val(entry.get('value', 0.0))}")
        return "\n".join(lines) + "\n"


def _fmt_val(v: float) -> str:
    v = float(v)
    if math.isnan(v):
        return "NaN"             # repr() would emit 'nan'/'inf', which
    if math.isinf(v):            # no Prometheus parser accepts
        return "+Inf" if v > 0 else "-Inf"
    return str(int(v)) if v.is_integer() and abs(v) < 1e15 else repr(v)


def json_safe(obj):
    """Replace non-finite floats with their string names so the output is
    strict RFC 8259 JSON.  Python's json emits bare ``NaN``/``Infinity``
    tokens by default — and the rows that carry them (NaN-loss probes,
    anomaly events, crash bundles) are exactly the ones downstream jq /
    JSON.parse / Go pipelines must be able to read."""
    if isinstance(obj, float):
        if math.isnan(obj):
            return "NaN"
        if math.isinf(obj):
            return "Infinity" if obj > 0 else "-Infinity"
        return obj
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# run journal
# ---------------------------------------------------------------------------

class RunJournal:
    """Append-only JSONL event log for one training run.

    Each row: ``{"seq": n, "ts": unix_s, "event": name, "step": id, ...}``.
    ``seq`` is strictly monotonic per journal; ``step`` is the training-step
    id the event belongs to — events recorded without one inherit the last
    seen step, so checkpoint/worker/fault rows correlate with the
    `step_dispatched` row (and the `profiler.step_annotation` range of the
    same id in a `torch.profiler` trace) that preceded them."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._lock = threading.Lock()
        self._seq = 0
        self._last_step = 0
        self._closed = False
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            # line-buffered append: rows survive a crash up to the last line
            self._f = open(self.path, "a", buffering=1)
        except OSError as e:
            # an unwritable journal path must degrade to a disabled journal,
            # not abort the training run that asked for observability
            self._f = None
            self._closed = True
            _log.warning("run journal disabled: cannot open %s (%s)",
                         self.path, e)

    @property
    def disabled(self) -> bool:
        """True when the journal could not open its file (or was closed);
        `record` is a silent no-op in that state."""
        return self._closed

    def record(self, event: str, step: Optional[int] = None,
               **fields) -> None:
        with self._lock:
            if self._closed:
                return
            if step is not None:
                self._last_step = int(step)
            self._seq += 1
            row = {"seq": self._seq, "ts": round(time.time(), 6),
                   "event": event, "step": self._last_step}
            row.update(fields)
            try:
                self._f.write(json.dumps(json_safe(row), default=str,
                                         allow_nan=False) + "\n")
            except (OSError, ValueError, TypeError):
                pass  # a full disk must not take the training loop down

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                try:
                    if self._f is not None:
                        self._f.close()
                except OSError:
                    pass

    @staticmethod
    def read(path: str) -> List[dict]:
        """Parse a journal file back into rows (tests, tools)."""
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return rows

    @staticmethod
    def tail(path: str, n: int = 500) -> List[dict]:
        """The last `n` rows — bounded excerpts (incident capsules) from
        journals that may have grown for hours.  Reads at most ~256 KiB
        per requested row from the file's end, not the whole file."""
        budget = max(4096, 256 * 1024)
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - budget))
            chunk = f.read().decode("utf-8", errors="replace")
        lines = chunk.splitlines()
        if size > budget and lines:
            lines = lines[1:]   # first line is likely truncated
        rows = []
        for line in lines[-n:]:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except ValueError:
                continue
        return rows

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# memory monitor
# ---------------------------------------------------------------------------

def _host_rss_bytes() -> Optional[int]:
    try:  # /proc is authoritative on linux; statm field 2 = resident pages
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


class MemoryMonitor:
    """Samples device + host memory into registry gauges.

    Per sample and visible card: ``device_live_bytes{device=}`` (bytes
    held by live tensors, ``allocated_bytes.all.current`` of
    ``torch.cuda.memory_stats`` — the framework's own footprint) and
    ``device_memory_in_use_bytes{device=}`` (bytes the caching allocator
    reserved from CUDA, ``reserved_bytes.all.current``), plus
    ``host_rss_bytes``.  `start()` runs `sample_once` on a daemon thread
    every `interval` seconds (``MXTPU_MEMMON_INTERVAL``); `sample_once` is
    also public for on-demand probes.  torch is imported lazily —
    constructing a monitor costs nothing until the first sample, and a
    process with no card records host RSS only."""

    def __init__(self, interval: float = 10.0,
                 registry: Optional[MetricsRegistry] = None):
        self.interval = float(interval)
        self._registry = registry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else registry()

    def sample_once(self) -> dict:
        reg = self._reg()
        live: Dict[str, int] = {}
        stats: Dict[str, dict] = {}
        try:
            import torch
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
        except Exception:
            n = 0
        for i in range(n):
            try:
                ms = torch.cuda.memory_stats(i)
            except Exception:
                continue
            d = f"cuda:{i}"
            live[d] = int(ms.get("allocated_bytes.all.current", 0))
            stats[d] = {"bytes_in_use": int(
                ms.get("reserved_bytes.all.current", 0)),
                "peak_bytes_in_use": int(
                    ms.get("allocated_bytes.all.peak", 0))}
        g_live = reg.gauge("device_live_bytes",
                           "Bytes held by live tensors per device",
                           labelnames=("device",))
        for dev, nbytes in live.items():
            g_live.set(nbytes, device=dev)
        for dev, ms in stats.items():
            reg.gauge("device_memory_in_use_bytes",
                      "Allocator bytes reserved per device "
                      "(torch.cuda.memory_stats)",
                      labelnames=("device",)).set(
                          ms["bytes_in_use"], device=dev)
        rss = _host_rss_bytes()
        if rss is not None:
            reg.gauge("host_rss_bytes",
                      "Host resident set size of this process").set(rss)
        self.samples += 1
        return {"live_bytes": live, "memory_stats": stats, "host_rss": rss}

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.sample_once()
            except Exception as e:  # monitoring must never kill the run
                _log.warning("memory monitor sample failed: %s", e)

    def start(self) -> "MemoryMonitor":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="mxtpu-memmon", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None


# ---------------------------------------------------------------------------
# HTTP exposition (stdlib only)
# ---------------------------------------------------------------------------

class MetricsServer:
    """Background ``http.server`` thread serving the registry:
    ``/metrics`` (Prometheus text), ``/metrics.json`` (JSON snapshot),
    ``/healthz`` (watchdog heartbeat ages + stall state as JSON — a
    liveness probe that answers "is the training loop still moving"
    without parsing the full exposition).
    Port 0 binds an ephemeral port (read it back from ``.port``).
    Binds loopback by default — exposing runtime internals on all
    interfaces is an explicit opt-in (``MXTPU_METRICS_HOST=0.0.0.0``)."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None):
        self._requested = (host, int(port))
        self._registry = registry
        self._httpd = None
        self._thread = None
        self.port: Optional[int] = None

    def start(self) -> "MetricsServer":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        reg = self._registry if self._registry is not None else registry()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib API name
                if self.path.split("?")[0] in ("/metrics.json", "/json"):
                    body = reg.to_json(indent=2).encode()
                    ctype = "application/json"
                elif self.path.split("?")[0] == "/healthz":
                    # lazy import: health imports telemetry at module load,
                    # so telemetry can only reach back at request time
                    from . import health as _health
                    body = json.dumps(
                        _health.healthz(), indent=2).encode()
                    ctype = "application/json"
                elif self.path.split("?")[0] in ("/", "/metrics"):
                    body = reg.to_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                _log.debug("metrics server: " + fmt, *args)

        self._httpd = ThreadingHTTPServer(self._requested, Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="mxtpu-metrics-http",
            daemon=True)
        self._thread.start()
        _log.info("telemetry: serving /metrics on port %d", self.port)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


# ---------------------------------------------------------------------------
# process-wide state + module-level facade
# ---------------------------------------------------------------------------

_registry = MetricsRegistry()
_enabled = False
_journal: Optional[RunJournal] = None
_server: Optional[MetricsServer] = None
_memmon: Optional[MemoryMonitor] = None
_state_lock = threading.Lock()
_event_taps: List[Callable[[dict], None]] = []
_atexit_registered = False


def registry() -> MetricsRegistry:
    """The process-wide default registry (always usable, enabled or not)."""
    return _registry


def counter(name, help="", labelnames=()) -> Counter:
    return _registry.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return _registry.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None) -> Histogram:
    return _registry.histogram(name, help, labelnames, buckets)


def snapshot() -> dict:
    return _registry.snapshot()


def to_prometheus() -> str:
    return _registry.to_prometheus()


def to_json(indent=None) -> str:
    return _registry.to_json(indent=indent)


def enabled() -> bool:
    """One global read — the no-op fast path every instrumentation site
    guards on."""
    return _enabled


def journal() -> Optional[RunJournal]:
    return _journal


def event(name: str, step: Optional[int] = None, **fields) -> None:
    """Record a journal event; no-op when telemetry is disabled
    (instrumentation sites call this unconditionally after their
    `enabled()` guard).  The event goes to the run journal (when one is
    attached) AND to any registered taps — the crash flight recorder
    (`mx.health`) rides a tap so it sees every event even when no journal
    file is open."""
    if not _enabled:
        return
    j = _journal
    if j is not None:
        j.record(name, step=step, **fields)
    if _event_taps:
        row = {"ts": round(time.time(), 6), "event": name, "step": step}
        row.update(fields)
        for tap in tuple(_event_taps):
            try:
                tap(row)
            except Exception:  # a broken tap must not take training down
                _log.debug("telemetry event tap failed", exc_info=True)


def add_event_tap(tap: Callable[[dict], None]) -> None:
    """Register a callable invoked with every `event()` row dict (after
    the journal write).  Taps must be fast and never raise; used by the
    `health` flight recorder."""
    if tap not in _event_taps:
        _event_taps.append(tap)


def remove_event_tap(tap: Callable[[dict], None]) -> None:
    try:
        _event_taps.remove(tap)
    except ValueError:
        pass


def enable(journal_path: Optional[str] = None,
           port: Optional[int] = None,
           memmon_interval: Optional[float] = None) -> None:
    """Turn the instrumentation on.

    `journal_path`: open a :class:`RunJournal` there (replacing any active
    one).  `port`: start the metrics HTTP server (default: the
    ``MXTPU_METRICS_PORT`` env var; 0 = ephemeral).  `memmon_interval`:
    start the :class:`MemoryMonitor` at that period in seconds (default:
    ``MXTPU_MEMMON_INTERVAL``; unset/<=0 = no background sampling).
    Idempotent: a second call merges — it can attach a journal or server
    to an already-enabled process."""
    global _enabled, _journal, _server, _memmon
    with _state_lock:
        if journal_path is not None:
            if _journal is not None:
                _journal.close()
            _journal = RunJournal(journal_path)
        if port is None:
            env_port = os.environ.get(ENV_PORT, "").strip()
            if env_port:
                try:
                    port = int(env_port)
                except ValueError:
                    _log.warning("ignoring non-integer %s=%r",
                                 ENV_PORT, env_port)
        if port is not None and _server is None:
            host = os.environ.get("MXTPU_METRICS_HOST", "127.0.0.1")
            try:
                _server = MetricsServer(port, host=host).start()
            except OSError as e:
                _log.warning("telemetry: metrics server failed to bind "
                             "port %s (%s); continuing without", port, e)
                _server = None
        if memmon_interval is None:
            env_iv = os.environ.get(ENV_MEMMON, "").strip()
            if env_iv:
                try:
                    memmon_interval = float(env_iv)
                except ValueError:
                    _log.warning("ignoring non-numeric %s=%r",
                                 ENV_MEMMON, env_iv)
        if memmon_interval is not None and memmon_interval > 0 \
                and _memmon is None:
            _memmon = MemoryMonitor(interval=memmon_interval).start()
        _enabled = True
        global _atexit_registered
        if not _atexit_registered:
            # join the monitor/server threads (and flush the journal) at
            # interpreter exit, so pytest/bench processes never tear down
            # with a daemon thread mid-sample
            atexit.register(_atexit_shutdown)
            _atexit_registered = True


def disable() -> None:
    """Turn instrumentation off and release the journal/server/monitor.
    The registry keeps its values (still snapshottable post-run)."""
    global _enabled, _journal, _server, _memmon
    with _state_lock:
        _enabled = False
        if _memmon is not None:
            _memmon.stop()
            _memmon = None
        if _server is not None:
            _server.stop()
            _server = None
        if _journal is not None:
            _journal.close()
            _journal = None


def _atexit_shutdown() -> None:
    """Interpreter-exit hook (registered by the first `enable`): stop and
    JOIN the memory-monitor and HTTP-server threads and close the journal.
    Daemon threads otherwise die mid-sample when the interpreter tears
    down — under pytest that shows up as leaked threads between runs."""
    try:
        disable()
    except Exception:
        pass


def metrics_server() -> Optional[MetricsServer]:
    return _server


def memory_monitor() -> Optional[MemoryMonitor]:
    return _memmon


def serve_metrics(port: Optional[int] = None,
                  host: str = "127.0.0.1") -> MetricsServer:
    """Start (and return) a metrics HTTP server outside of `enable` —
    for embedding in an existing serving process."""
    if port is None:
        port = int(os.environ.get(ENV_PORT, "0") or 0)
    return MetricsServer(port, host=host).start()


# ---------------------------------------------------------------------------
# compile-cache hit/miss listener
# ---------------------------------------------------------------------------

def install_compile_cache_listener() -> bool:
    """JAX feeds ``compile_cache_hits`` / ``compile_cache_misses`` from its
    persistent XLA compile cache (`runtime.enable_compile_cache`).  The
    port's kernels are built once per source hash into the build
    directory (`kernels`), and the runtime's feature flags and compile
    cache are not ported: raises `MXNetError` naming the item."""
    from .base import MXNetError
    raise MXNetError(
        "telemetry.install_compile_cache_listener: the runtime's compile "
        "cache (runtime.py) is not ported yet (ROADMAP.md A1)")


def _in_child_process() -> bool:
    """True inside a multiprocessing child.  Auto-enable must not run
    there: each child would append to the parent's journal with its own
    seq counter (breaking the per-journal monotonic-seq contract), retry
    the metrics-port bind, and start a memory monitor per short-lived
    child."""
    try:
        import multiprocessing
        return multiprocessing.parent_process() is not None
    except Exception:
        return False


# auto-enable from the environment: MXTPU_TELEMETRY=1 (or any truthy value)
# enables instrumentation; a value that looks like a path additionally opens
# the run journal there (e.g. MXTPU_TELEMETRY=/logs/run.jsonl). Parent
# process only — children stay dark (their metrics would be process-local
# and unreachable anyway).
_env = os.environ.get(ENV_ENABLE, "").strip()
if _env and _env.lower() not in ("0", "false", "no", "off") \
        and not _in_child_process():
    _is_path = os.sep in _env or _env.endswith(".jsonl")
    enable(journal_path=_env if _is_path else None)
del _env
