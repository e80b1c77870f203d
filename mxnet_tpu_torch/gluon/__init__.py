"""Gluon pieces of the port: the losses and the `Trainer`."""
from . import loss  # noqa: F401
from .loss import (  # noqa: F401
    Loss, SoftmaxCrossEntropyLoss, SoftmaxCELoss)
from .trainer import Trainer  # noqa: F401

__all__ = ["loss", "Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "Trainer"]
