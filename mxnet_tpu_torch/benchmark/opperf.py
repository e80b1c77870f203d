"""Per-operator timing harness (counterpart of
``mxnet_tpu/benchmark/opperf.py`` ``time_callable``; the rest of that
module's per-op benchmark suite waits for a later slice, ROADMAP.md).

`time_callable` is the measurement contract the autotuner
(`ops.autotune.tune`) consumes: every run is bracketed by
``torch.cuda.synchronize()`` when a card is in use, so a sample is one
launch and its execution, never an asynchronous enqueue.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict

import torch

__all__ = ["time_callable"]


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_callable(fn: Callable[[], object], warmup: int = 1,
                  runs: int = 5) -> Dict[str, float]:
    """Time a zero-argument thunk, run to completion each time.

    Every warmup run finishes (and synchronises) before the first timed
    run, so kernel builds and lazy initialisation never reach the
    samples; each timed run is bracketed by a synchronise on both sides;
    the headline number is the median of the `runs` samples.  Returns
    ``{"median_ms", "mean_ms", "min_ms", "max_ms", "runs", "warmup"}``,
    the JAX harness's schema."""
    runs = max(1, int(runs))
    for _ in range(max(0, int(warmup))):
        fn()
        _sync()
    samples = []
    for _ in range(runs):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        samples.append((time.perf_counter() - t0) * 1e3)
    return {
        "median_ms": statistics.median(samples),
        "mean_ms": sum(samples) / len(samples),
        "min_ms": min(samples),
        "max_ms": max(samples),
        "runs": runs,
        "warmup": max(0, int(warmup)),
    }
