"""Training steps of the port (one card so far), the Switch MoE layer and
the device prefetcher."""
from .train import TrainStep, StepHandle, make_train_step  # noqa: F401
from .moe import MoEFeedForward, switch_moe  # noqa: F401
from .prefetch import (DevicePrefetcher, AsyncMetricBuffer,  # noqa: F401
                       default_prefetch_depth)

__all__ = ["TrainStep", "StepHandle", "make_train_step", "MoEFeedForward",
           "switch_moe", "DevicePrefetcher", "AsyncMetricBuffer",
           "default_prefetch_depth"]
