"""Adam and AdamW (counterparts of ``mxnet_tpu/optimizer/adam.py``): the
same elementwise rules, with the same order of operations."""
from __future__ import annotations

import math

import torch

from .optimizer import Optimizer, register


def _sqrt(x):
    """``jnp.sqrt`` of a tensor or a Python number."""
    return torch.sqrt(x) if torch.is_tensor(x) else math.sqrt(x)


@register
class Adam(Optimizer):
    fused_elementwise = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, weight, dtype=None):
        return (torch.zeros_like(weight, dtype=dtype),
                torch.zeros_like(weight, dtype=dtype))

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + hp["wd"] * w
        m, v = s
        t = hp["t"]
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g * g
        lr = hp["lr"] * _sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        w = w - lr * m / (torch.sqrt(v) + self.epsilon)
        return w, (m, v)


@register
class AdamW(Optimizer):
    """Decoupled weight decay."""
    fused_elementwise = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.correct_bias = correct_bias

    def create_state(self, weight, dtype=None):
        return (torch.zeros_like(weight, dtype=dtype),
                torch.zeros_like(weight, dtype=dtype))

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp)
        m, v = s
        t = hp["t"]
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g * g
        lr = hp["lr"]
        if self.correct_bias:
            lr = lr * _sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        w = w - lr * m / (torch.sqrt(v) + self.epsilon) - \
            hp["lr"] * hp["wd"] * w
        return w, (m, v)
