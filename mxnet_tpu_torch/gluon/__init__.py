"""Gluon pieces of the port (losses so far)."""
from . import loss  # noqa: F401
from .loss import (  # noqa: F401
    Loss, SoftmaxCrossEntropyLoss, SoftmaxCELoss)

__all__ = ["loss", "Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]
