"""Gluon of the port (counterpart of ``mxnet_tpu/gluon/``): `Block` /
`HybridBlock` over ``torch.nn.Module``, `Parameter`, the layers of
`gluon.nn`, the losses, the metrics, `gluon.utils` and the `Trainer`.
`gluon.data` waits for ROADMAP.md A13."""
from . import block, parameter  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import (  # noqa: F401
    Parameter, Constant, DeferredInitializationError)
from . import nn, loss, metric, utils  # noqa: F401
from .loss import (  # noqa: F401
    Loss, SoftmaxCrossEntropyLoss, SoftmaxCELoss)
from .trainer import Trainer  # noqa: F401

__all__ = ["block", "parameter", "Block", "HybridBlock", "SymbolBlock",
           "Parameter", "Constant", "DeferredInitializationError", "nn",
           "loss", "metric", "utils", "Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss", "Trainer"]
