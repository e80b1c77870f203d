"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``): the base
class, its registry, the rules the training step and the `Trainer` run —
Adam, AdamW, SGD and LAMB — and the `Updater` that saves their state."""
from .optimizer import Optimizer, register, create  # noqa: F401
from .adam import Adam, AdamW  # noqa: F401
from .sgd import SGD  # noqa: F401
from .lamb import LAMB  # noqa: F401
from .updater import Updater  # noqa: F401

__all__ = ["Optimizer", "register", "create", "Adam", "AdamW", "SGD", "LAMB",
           "Updater"]
