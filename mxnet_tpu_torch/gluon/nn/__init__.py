"""`gluon.nn` of the port (counterpart of ``mxnet_tpu/gluon/nn/``): the
basic layers and the activations.  The convolution and pooling layers
wait for ROADMAP.md A11."""
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .basic_layers import (  # noqa: F401
    Sequential, HybridSequential, Dense, Dropout, Embedding, BatchNorm,
    BatchNormReLU, SyncBatchNorm, LayerNorm, RMSNorm, GroupNorm,
    InstanceNorm, Flatten, Lambda, HybridLambda, Concatenate,
    HybridConcatenate, Identity, Activation)
from .activations import (  # noqa: F401
    LeakyReLU, PReLU, ELU, SELU, GELU, Swish, SiLU)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Sequential",
           "HybridSequential", "Dense", "Dropout", "Embedding", "BatchNorm",
           "BatchNormReLU", "SyncBatchNorm", "LayerNorm", "RMSNorm",
           "GroupNorm", "InstanceNorm", "Flatten", "Lambda", "HybridLambda",
           "Concatenate", "HybridConcatenate", "Identity", "Activation",
           "LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "Swish", "SiLU"]
