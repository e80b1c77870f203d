"""Gluon of the port (counterpart of ``mxnet_tpu/gluon/``): `Block` /
`HybridBlock` over ``torch.nn.Module``, `Parameter`, the layers of
`gluon.nn`, the losses, the metrics, `gluon.utils`, the `Trainer`,
`gluon.data` (datasets, samplers, batchify, the `DataLoader`) and
`gluon.model_zoo` (the vision models)."""
from . import block, parameter  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import (  # noqa: F401
    Parameter, Constant, DeferredInitializationError)
from . import nn, loss, metric, utils, data  # noqa: F401
from .loss import (  # noqa: F401
    Loss, SoftmaxCrossEntropyLoss, SoftmaxCELoss)
from .trainer import Trainer  # noqa: F401
from . import model_zoo  # noqa: F401

__all__ = ["block", "parameter", "Block", "HybridBlock", "SymbolBlock",
           "Parameter", "Constant", "DeferredInitializationError", "nn",
           "loss", "metric", "utils", "data", "Loss",
           "SoftmaxCrossEntropyLoss", "SoftmaxCELoss", "Trainer", "model_zoo"]
