"""SGD with momentum (counterpart of ``mxnet_tpu/optimizer/sgd.py``
``SGD``): the same elementwise rule, with the same order of operations."""
from __future__ import annotations

import torch

from .optimizer import Optimizer, register, weak


@register
class SGD(Optimizer):
    """SGD with weight decay added to the gradient (``grad += wd * w``, as
    the reference) and optional momentum: state ``()`` without momentum,
    ``(mom,)`` with it."""
    fused_elementwise = True

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, weight, dtype=None):
        if self.momentum != 0.0:
            return (torch.zeros_like(weight, dtype=dtype),)
        return ()

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + hp["wd"] * w
        if self.momentum != 0.0:
            (mom,) = s
            mom = weak(self.momentum, mom) * mom - hp["lr"] * g
            return w + mom, (mom,)
        return w - hp["lr"] * g, ()
