"""Per-operator timing harness (counterpart of
``mxnet_tpu/benchmark/opperf.py`` ``time_callable``; the rest of that
module's per-op benchmark suite waits for a later slice, ROADMAP.md).

`time_callable` is the measurement contract the autotuner
(`ops.autotune.tune`) consumes.  On a CUDA device each sample is the
device time of one call: CUDA events around it, after the L2 is flushed
and the card is held long enough for the call to be enqueued.
Elsewhere it is the host clock between two synchronisations, so a sample
is one call run to completion, never an asynchronous enqueue.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List

import torch

__all__ = ["time_callable"]

#: bytes zeroed before each timed call on a card: over five times the
#: H100's 50 MB L2, so a trial finds its inputs cold, as a step does
FLUSH_BYTES = 256 << 20
#: device cycles the card sleeps after each flush (~1 ms at the H100's
#: clocks, longer than a trial's host time), so the call is enqueued
#: before the start event runs and its host time never reaches a sample
SLEEP_CYCLES = 2_000_000


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _host_samples(fn, warmup: int, runs: int) -> List[float]:
    for _ in range(warmup):
        fn()
        _sync()
    samples = []
    for _ in range(runs):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        samples.append((time.perf_counter() - t0) * 1e3)
    return samples


def _event_samples(fn, warmup: int, runs: int, device) -> List[float]:
    """CUDA events around each call on `device`'s current stream, the
    start recorded after the flush and a `SLEEP_CYCLES` device sleep are
    enqueued; one synchronise at the end."""
    with torch.cuda.device(device):
        for _ in range(warmup):
            fn()
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                            device=device)
        torch.cuda.synchronize()
        evs = []
        for _ in range(runs):
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            evs.append((start, end))
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in evs]


def time_callable(fn: Callable[[], object], warmup: int = 1,
                  runs: int = 5, device=None) -> Dict[str, float]:
    """Time a zero-argument thunk that runs its work on `device`.

    Every warmup run finishes before the first timed run, so kernel
    builds and lazy initialisation never reach the samples.  On a CUDA
    `device` (a `torch.device` or its string) each timed run is bracketed
    by CUDA events after a `FLUSH_BYTES` L2 flush and a device sleep that
    keeps the wrapper's host time out of it; otherwise (the CPU, or
    no device given) by the host clock between synchronisations.  The
    headline number is the median of the `runs` samples.  Returns
    ``{"median_ms", "mean_ms", "min_ms", "max_ms", "runs", "warmup"}``,
    the JAX harness's schema."""
    runs = max(1, int(runs))
    warmup = max(0, int(warmup))
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda":
        samples = _event_samples(fn, warmup, runs, dev)
    else:
        samples = _host_samples(fn, warmup, runs)
    return {
        "median_ms": statistics.median(samples),
        "mean_ms": sum(samples) / len(samples),
        "min_ms": min(samples),
        "max_ms": max(samples),
        "runs": runs,
        "warmup": warmup,
    }
