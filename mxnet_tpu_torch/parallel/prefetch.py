"""Async input pipeline of the port (counterpart of
``mxnet_tpu/parallel/prefetch.py``: the same classes, fault point, stats
and error propagation).

The reference overlaps H2D copies, compute, and host work through its
dependency engine (`Engine::PushAsync`) plus the IO prefetcher
(`src/io/iter_prefetcher.cc`: a background thread keeps a bounded buffer of
decoded batches ahead of the consumer).  CUDA already overlaps compute
through asynchronous launches; what the host loop still serializes is (a)
the host→device copy of every batch and (b) the device→host ``float(loss)``
fetch that blocks the host on the card every step.  Two pieces here remove
both stalls:

* :class:`DevicePrefetcher` — wraps any iterator/`DataLoader` and places
  each batch on the device from a background thread with depth-N
  buffering, so batch *k+1* (and beyond) is already on the card when the
  step for batch *k* is dispatched.  On the card the thread copies on a
  CUDA stream of its own, from pinned host memory, and records an event
  per batch; the consumer's ``next()`` makes ITS current stream wait on
  that event (never a device-wide sync, which would undo the overlap) and
  marks every handed-out tensor as used by that stream
  (``record_stream``), so the caching allocator cannot hand the buffer to
  a later copy while the step still reads it.  On the CPU it places with
  ``.to(device)`` and uses no stream.
* :class:`AsyncMetricBuffer` — defers the per-step scalar fetch; losses
  accumulate as device scalars and are fetched in one batched
  device→host read every ``drain_every`` steps, keeping several steps in
  flight between host syncs.

Both are fault-aware: the prefetch thread passes through the
``prefetch_next`` injection point (``MXTPU_FAULT_SPEC``), and any error —
injected or real, a failed copy included — tears the pipeline down cleanly
and re-raises in the consumer (no hang, no batch buffers stranded in the
queue, no quiet fallback to the CPU).
"""
from __future__ import annotations

import os
import queue as _queue
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as _onp
import torch

from ..base import MXNetError
from ..device import current_device, resolve_device
from ..resilience import fault_point
from .. import health as _health
from .. import telemetry as _tele
from .. import tracing as _trace

__all__ = ["DevicePrefetcher", "AsyncMetricBuffer", "default_prefetch_depth"]

ENV_DEPTH = "MXTPU_PREFETCH_DEPTH"


def default_prefetch_depth() -> int:
    """Depth-N double buffering default: ``MXTPU_PREFETCH_DEPTH`` (>= 1),
    else 2 — one batch being consumed, one staged ahead."""
    try:
        depth = int(os.environ.get(ENV_DEPTH, "2"))
    except ValueError:
        depth = 2
    return max(1, depth)


def _tensors(tree):
    """Every tensor of a placed batch (tuples, lists, dicts; arrays by
    their tensor)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)
    elif isinstance(getattr(tree, "_data", None), torch.Tensor):
        yield tree._data


class DevicePrefetcher:
    """Iterate `source`, device-placing each batch on a background thread.

    `place` maps one source item to its device-resident form; batches that
    are tuples/lists are splatted (``place(*item)``).  The default places
    every leaf — a NumPy array, a tensor, an `mx.np` array, and the
    tuples, lists and dicts holding them — as a torch tensor on the
    device current where the prefetcher is built (the card unless a
    ``with mx.cpu():`` scope says otherwise).  The bounded
    queue (``depth``) gives backpressure: the thread stays at most
    ``depth + 1`` batches ahead (``depth`` queued plus the one it placed
    and is waiting to enqueue), so prefetch memory is capped at
    ``(depth + 1) x batch_bytes`` on the device.

    Iteration yields placed batches in source order.  An exception on the
    prefetch thread (dataset bug, placement failure, injected fault) is
    re-raised to the consumer on its next ``next()``; the thread and queue
    are torn down first.  `close()` (also via context-manager exit) stops
    the thread and drops buffered batches — safe to call mid-epoch.
    """

    def __init__(self, source: Iterable, place: Optional[Callable] = None,
                 depth: Optional[int] = None, timeout: float = 120.0):
        self._source = source
        self._place = place if place is not None else self._default_place
        self._depth = default_prefetch_depth() if depth is None else int(depth)
        if self._depth < 1:
            raise MXNetError(f"prefetch depth must be >= 1, got {self._depth}")
        # the device current here: the worker thread runs under it (the
        # port's current device is per thread), places there and, on the
        # card, copies on a stream of its own
        self._scope = current_device()
        self._device = resolve_device(self._scope)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        # timeout bounds each consumer wait: a wedged source raises instead
        # of deadlocking the training loop (DataLoader timeout semantics)
        self._timeout = timeout
        self._q: _queue.Queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._exhausted = False
        # occupancy stats (read via stats()): how full the window was at
        # each hand-out, and how long the consumer waited — the two numbers
        # that say whether depth is too small (drained window, long waits)
        self._occ_sum = 0
        self._batches = 0
        self._wait_s = 0.0
        # checkpoint-lag accounting (data.DataPipeline): how far this
        # prefetcher has pulled the source AHEAD of the consumer — the
        # number of batches a naive "current source state" checkpoint
        # would skip on resume (the pipeline's state ring exists to make
        # that lag harmless; pending() makes it observable)
        self._pulled = 0
        self._delivered = 0
        # cross-thread span handoff (mx.tracing): the prefetch worker's
        # placement spans parent under whatever span was open on the
        # CONSTRUCTING (consumer) thread — e.g. a training loop's outer
        # span — so the H2D work nests in the consumer's trace instead
        # of starting orphan traces on the worker thread
        self._trace_ctx = (_trace.get_tracer("data").current_context()
                           if _trace.enabled() else None)
        self._thread = threading.Thread(target=self._worker,
                                        name="mxtpu-prefetch", daemon=True)
        self._thread.start()

    # -- producer (background thread) ----------------------------------
    @property
    def stream(self) -> Optional[torch.cuda.Stream]:
        """The copy stream (None on the CPU)."""
        return self._stream

    def _to_device(self, x):
        if isinstance(x, (tuple, list)):
            return type(x)(self._to_device(v) for v in x)
        if isinstance(x, dict):
            return {k: self._to_device(v) for k, v in x.items()}
        t = getattr(x, "_data", x)
        if isinstance(t, _onp.ndarray):
            t = torch.from_numpy(t)
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t)
        if t.device == self._device:
            return t
        if self._stream is not None and t.device.type == "cpu":
            # asynchronous copy from pinned memory on the copy stream
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _default_place(self, *items):
        placed = tuple(self._to_device(b) for b in items)
        return placed if len(placed) != 1 else placed[0]

    def _apply_place(self, item):
        if isinstance(item, (tuple, list)):
            return self._place(*item)
        placed = self._place(item)
        # a bare (non-tuple) source item comes back bare whatever the
        # hook returns: a hook that always returns a tuple would
        # otherwise turn every yielded batch into a 1-tuple
        if isinstance(placed, tuple) and len(placed) == 1:
            return placed[0]
        return placed

    def _place_on_device(self, item):
        """(placed batch, ready event): on the card the placement runs on
        the copy stream and the event marks its end there."""
        if self._stream is None:
            return self._apply_place(item), None
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            placed = self._apply_place(item)
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def _put(self, entry) -> bool:
        """Stop-aware bounded put; False when closed mid-wait."""
        while not self._stop.is_set():
            try:
                self._q.put(entry, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def _worker(self):
        with self._scope:
            self._produce()

    def _produce(self):
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                fault_point("prefetch_next")
                self._pulled += 1
                # named heartbeat for the hang watchdog (mx.health): a
                # wedged placement/source stops touching it and shows up
                # by name in the stall dump
                _health.beat("prefetch")
                p_span = _trace.get_tracer("data").start_span(
                    "prefetch.place", parent=self._trace_ctx,
                    track="prefetch", batch=self._pulled) \
                    if _trace.enabled() else None
                placed = self._place_on_device(item)
                if p_span is not None:
                    p_span.finish()
                if not self._put(("item", placed)):
                    return
            self._put(("end", None))
        except BaseException as e:  # incl. FaultExit — consumer decides
            self._put(("error", e))

    # -- consumer -------------------------------------------------------
    def __iter__(self):
        return self

    def _hand_out(self, placed, event):
        """Order the consumer's stream after the batch's copy, and keep
        the copy's buffers from reuse until that stream is done with
        them."""
        if event is None:
            return placed
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(event)
        for t in _tensors(placed):
            if t.device.type == "cuda":
                t.record_stream(consumer)
        return placed

    def __next__(self):
        if self._exhausted or self._stop.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        # wait in short slices so a close() from another thread (elastic
        # shutdown, supervisor teardown) wakes this consumer promptly
        # instead of stalling it for the full timeout
        while True:
            try:
                kind, payload = self._q.get(timeout=0.05)
                break
            except _queue.Empty:
                if self._stop.is_set():
                    raise StopIteration
                if time.perf_counter() - t0 > self._timeout:
                    self.close()
                    raise MXNetError(
                        f"DevicePrefetcher: no batch arrived within "
                        f"{self._timeout}s (source iterator or device "
                        "placement is stuck); raise `timeout=` or debug "
                        "the input pipeline")
        wait = time.perf_counter() - t0
        self._wait_s += wait
        if kind == "item":
            self._batches += 1
            self._delivered += 1
            occ = self._q.qsize()
            self._occ_sum += occ
            if _tele.enabled():
                _tele.histogram(
                    "prefetch_wait_ms",
                    "Consumer wait per prefetched batch (ms); long waits "
                    "with low occupancy mean the source is the bottleneck"
                ).observe(wait * 1e3)
                _tele.gauge(
                    "prefetch_occupancy",
                    "Prefetch queue depth at hand-out (near depth = "
                    "prefetch is ahead)").set(occ)
                _tele.gauge(
                    "prefetch_pending",
                    "Batches pulled from the source but not yet "
                    "delivered to the consumer — the checkpoint-lag "
                    "window DataPipeline.state_at rewinds (docs/data.md)"
                ).set(self.pending())
            if _trace.enabled():
                _trace.get_tracer("data").record_span(
                    "prefetch.wait", t0, time.perf_counter(),
                    track="prefetch consumer", batch=self._delivered,
                    occupancy=occ)
            return self._hand_out(*payload)
        self._exhausted = True
        self.close()
        if kind == "error":
            raise payload
        raise StopIteration

    def skip(self, n: int = 1) -> int:
        """Fast-forward: consume and drop up to `n` batches (device
        buffers are released immediately).  The recovery rollback path
        uses this to step a forward-only stream past the poison window —
        the batches that fed anomalies on the abandoned timeline — so the
        replay does not re-train on them.  Returns the number actually
        dropped (short when the source ends first)."""
        dropped = 0
        for _ in range(int(n)):
            try:
                next(self)
            except StopIteration:
                # only a genuinely exhausted source ends the skip; a
                # pipeline error (worker failure, placement fault, wait
                # timeout) propagates — swallowing it here would leave a
                # dead prefetcher whose root cause surfaces nowhere
                break
            dropped += 1
        if dropped and _tele.enabled():
            _tele.counter(
                "prefetch_skipped_batches",
                "Prefetched batches dropped by recovery fast-forward"
            ).inc(dropped)
        return dropped

    # -- lifecycle ------------------------------------------------------
    def _drain_queue(self):
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass

    def close(self, timeout: float = 5.0):
        """Stop the prefetch thread and drop buffered batches. Idempotent;
        never hangs: the producer's puts are stop-aware, and the queue is
        drained so a blocked put wakes immediately.  Drained again AFTER
        the join: a producer woken from its blocked put can deposit one
        last batch after the first drain saw Empty — without the re-drain
        that device buffer would stay pinned in the dead queue."""
        self._stop.set()
        self._drain_queue()
        t = self._thread
        if t is not threading.current_thread() and t.is_alive():
            t.join(timeout)
        self._drain_queue()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close(timeout=0.2)
        except Exception:
            pass

    def pending(self) -> int:
        """Batches pulled from the source but not yet delivered to the
        consumer (buffered + in placement).  This is the gap between
        "where the source is" and "where training is" — exactly the
        number of batches `data.DataPipeline.state_at` rewinds when a
        checkpoint lands while the window is full (docs/data.md)."""
        return max(0, self._pulled - self._delivered)

    def stats(self) -> dict:
        """Pipeline health: {'depth', 'batches', 'mean_occupancy',
        'mean_wait_ms', 'pending'}. mean_occupancy near 0 with long waits
        means the source (not the consumer) is the bottleneck — raise
        depth or speed up the loader; occupancy near depth means prefetch
        is ahead."""
        n = max(1, self._batches)
        return {
            "depth": self._depth,
            "batches": self._batches,
            "mean_occupancy": round(self._occ_sum / n, 3),
            "mean_wait_ms": round(self._wait_s * 1e3 / n, 3),
            "pending": self.pending(),
        }


class AsyncMetricBuffer:
    """Deferred scalar-metric fetches: append device scalars (or
    ``StepHandle``s), fetch them in ONE batched device→host read every
    ``drain_every`` appends.  Between drains the host never blocks on the
    device, so up to ``drain_every`` steps stay in flight — the reference's
    ``metric.update`` every-k-batches idiom, made explicit.

    ``values`` holds the fetched floats in append order; ``drain()`` forces
    the fetch (call once after the loop).  ``max_in_flight`` records the
    deepest the pipeline ran — the bench reports it as ``steps_in_flight``.
    """

    def __init__(self, drain_every: int = 8):
        if drain_every < 1:
            raise MXNetError(
                f"drain_every must be >= 1, got {drain_every}")
        self.drain_every = int(drain_every)
        self._pending: list = []
        self.values: list = []
        self.max_in_flight = 0

    def append(self, value):
        self._pending.append(getattr(value, "loss", value))
        if len(self._pending) > self.max_in_flight:
            self.max_in_flight = len(self._pending)
        if len(self._pending) >= self.drain_every:
            self.drain()
        return self

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def drain(self) -> list:
        if self._pending:
            out = [getattr(v, "_data", v) for v in self._pending]
            by_dev = {}
            for i, v in enumerate(out):
                if isinstance(v, torch.Tensor):
                    by_dev.setdefault(v.device, []).append(i)
            for idx in by_dev.values():
                # one device->host read for the window's tensors
                host = torch.stack([out[i].detach().reshape(()).to(
                    torch.float64) for i in idx]).cpu().tolist()
                for i, v in zip(idx, host):
                    out[i] = v
            self.values.extend(float(v) for v in out)
            self._pending.clear()
        return self.values

    def mean(self, last_n: Optional[int] = None) -> float:
        vals = self.drain()
        if last_n is not None:
            vals = vals[-last_n:]
        if not vals:
            raise MXNetError("AsyncMetricBuffer.mean() on an empty buffer")
        return sum(vals) / len(vals)

    def __len__(self):
        return len(self.values) + len(self._pending)
