"""Training steps of the port (one card so far) and the Switch MoE layer."""
from .train import TrainStep, StepHandle, make_train_step  # noqa: F401
from .moe import MoEFeedForward, switch_moe  # noqa: F401

__all__ = ["TrainStep", "StepHandle", "make_train_step", "MoEFeedForward",
           "switch_moe"]
