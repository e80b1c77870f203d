"""Activation layers (counterpart of
``mxnet_tpu/gluon/nn/activations.py``)."""
from __future__ import annotations

import torch

from ...ops import nn as F
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "Swish", "SiLU"]


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return F.leaky_relu(x, slope=self._alpha)

    def extra_repr(self):
        return f"{self._alpha}"


class PReLU(HybridBlock):
    """Leaky ReLU whose slope ``alpha`` (one a channel) is learned;
    ``Constant(0.25)`` by default."""

    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        if alpha_initializer is None:
            from ...initializer import Constant
            alpha_initializer = Constant(0.25)
        self.alpha = Parameter("alpha", shape=(in_channels,),
                               init=alpha_initializer)

    def forward(self, x):
        return F.prelu(x, self.alpha.data())


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, alpha=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return F.selu(x)


class GELU(HybridBlock):
    def __init__(self, approximation="erf", **kwargs):
        super().__init__(**kwargs)
        self._approximation = approximation

    def forward(self, x):
        return F.gelu(x, approximation=self._approximation)


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)


class SiLU(HybridBlock):
    def forward(self, x):
        return F.silu(x)
