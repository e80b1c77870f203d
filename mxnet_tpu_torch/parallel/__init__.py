"""Training steps of the port (one card so far)."""
from .train import TrainStep, StepHandle, make_train_step  # noqa: F401

__all__ = ["TrainStep", "StepHandle", "make_train_step"]
