"""Benchmark helpers of the port (`opperf.time_callable`, the timing
harness the autotuner uses)."""
from .opperf import time_callable  # noqa: F401

__all__ = ["time_callable"]
