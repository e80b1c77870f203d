"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``): the base
class, its registry, and the Adam family used by the training step."""
from .optimizer import Optimizer, register, create  # noqa: F401
from .adam import Adam, AdamW  # noqa: F401

__all__ = ["Optimizer", "register", "create", "Adam", "AdamW"]
