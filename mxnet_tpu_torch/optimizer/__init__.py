"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``): the base
class and its registry, every rule the JAX package registers — the SGD
family (SGD, NAG, Signum, SGLD, DCASGD, LARS), the Adam family (Adam,
AdamW, AdaBelief, Adamax, Nadam, AdaDelta, FTML), the AdaGrad family
(AdaGrad, GroupAdaGrad, RMSProp, Ftrl, Test), LAMB and LANS — the
learning-rate schedulers, and the `Updater` that saves optimizer state."""
from .optimizer import Optimizer, register, create  # noqa: F401
from .sgd import SGD, NAG, Signum, SGLD, DCASGD, LARS  # noqa: F401
from .adam import (Adam, AdamW, AdaBelief, Adamax, Nadam, AdaDelta,  # noqa: F401
                   FTML)
from .adagrad import AdaGrad, GroupAdaGrad, RMSProp, Ftrl, Test  # noqa: F401
from .lamb import LAMB, LANS  # noqa: F401
from .updater import Updater  # noqa: F401
from . import lr_scheduler  # noqa: F401
from .lr_scheduler import (LRScheduler, FactorScheduler,  # noqa: F401
                           MultiFactorScheduler, PolyScheduler,
                           CosineScheduler)

__all__ = [
    "Optimizer", "register", "create", "SGD", "NAG", "Signum", "SGLD",
    "DCASGD", "LARS", "Adam", "AdamW", "AdaBelief", "Adamax", "Nadam",
    "AdaDelta", "FTML", "AdaGrad", "GroupAdaGrad", "RMSProp", "Ftrl", "Test",
    "LAMB", "LANS", "Updater", "LRScheduler", "FactorScheduler",
    "MultiFactorScheduler", "PolyScheduler", "CosineScheduler",
    "lr_scheduler",
]
