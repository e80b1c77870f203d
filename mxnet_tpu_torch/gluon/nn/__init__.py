"""`gluon.nn` of the port (counterpart of ``mxnet_tpu/gluon/nn/``): the
basic layers, the convolution and pooling layers and the activations."""
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .basic_layers import (  # noqa: F401
    Sequential, HybridSequential, Dense, Dropout, Embedding, BatchNorm,
    BatchNormReLU, SyncBatchNorm, LayerNorm, RMSNorm, GroupNorm,
    InstanceNorm, Flatten, Lambda, HybridLambda, Concatenate,
    HybridConcatenate, Identity, Activation)
from .conv_layers import (  # noqa: F401
    Conv1D, Conv2D, Conv3D, Conv1DTranspose, Conv2DTranspose,
    Conv3DTranspose, MaxPool1D, MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D,
    AvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D,
    GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D, ReflectionPad2D,
    PixelShuffle1D, PixelShuffle2D, PixelShuffle3D, DeformableConvolution,
    ModulatedDeformableConvolution)
from .activations import (  # noqa: F401
    LeakyReLU, PReLU, ELU, SELU, GELU, Swish, SiLU)
from . import conv_layers as _conv_layers

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Sequential",
           "HybridSequential", "Dense", "Dropout", "Embedding", "BatchNorm",
           "BatchNormReLU", "SyncBatchNorm", "LayerNorm", "RMSNorm",
           "GroupNorm", "InstanceNorm", "Flatten", "Lambda", "HybridLambda",
           "Concatenate", "HybridConcatenate", "Identity", "Activation",
           *_conv_layers.__all__,
           "LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "Swish", "SiLU"]
