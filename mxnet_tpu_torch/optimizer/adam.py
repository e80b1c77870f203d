"""The Adam family (counterpart of ``mxnet_tpu/optimizer/adam.py``): Adam,
AdamW, AdaBelief, Adamax, Nadam, AdaDelta and FTML, the same elementwise
rules with the same order of operations.  Python numbers beside a tensor
go through `weak` (rounded to a 16-bit tensor's dtype first, as JAX's
weakly typed scalars are)."""
from __future__ import annotations

import math

import torch

from .optimizer import Optimizer, register, sqrt, weak


def _sqrt(x):
    """``jnp.sqrt`` of a tensor or a Python number."""
    return sqrt(x) if torch.is_tensor(x) else math.sqrt(x)


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
        m = weak(self.beta1, m) * m + (1 - self.beta1) * g
        v = weak(self.beta2, v) * v + (1 - self.beta2) * g * g
        lr = hp["lr"] * _sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        w = w - lr * m / (sqrt(v) + self.epsilon)
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
        m = weak(self.beta1, m) * m + (1 - self.beta1) * g
        v = weak(self.beta2, v) * v + (1 - self.beta2) * g * g
        lr = hp["lr"]
        if self.correct_bias:
            lr = lr * _sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        w = w - lr * m / (sqrt(v) + self.epsilon) - \
            hp["lr"] * hp["wd"] * w
        return w, (m, v)


@register
class AdaBelief(Optimizer):
    """Adam with the belief ``(g - m)^2`` (the new m) in place of ``g^2``,
    epsilon added to v and again under the square root."""
    fused_elementwise = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-16, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, weight, dtype=None):
        return (torch.zeros_like(weight, dtype=dtype),
                torch.zeros_like(weight, dtype=dtype))

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + weak(hp["wd"], w) * w
        m, v = s
        t = hp["t"]
        m = weak(self.beta1, m) * m + weak(1 - self.beta1, g) * g
        d = g - m
        v = weak(self.beta2, v) * v + weak(1 - self.beta2, d) * torch.square(d)
        v = v + weak(self.epsilon, v)
        lr = hp["lr"] * _sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        return w - weak(lr, m) * m / (sqrt(v) + weak(self.epsilon, v)), \
            (m, v)


@register
class Adamax(Optimizer):
    """Adam with the infinity norm: ``u = max(beta2 * u, |g|)``, the step
    ``lr / (1 - beta1^t) * m / (u + 1e-8)``."""
    fused_elementwise = True

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, weight, dtype=None):
        return (torch.zeros_like(weight, dtype=dtype),
                torch.zeros_like(weight, dtype=dtype))

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + weak(hp["wd"], w) * w
        m, u = s
        t = hp["t"]
        m = weak(self.beta1, m) * m + weak(1 - self.beta1, g) * g
        u = torch.maximum(weak(self.beta2, u) * u, torch.abs(g))
        lr = hp["lr"] / (1 - self.beta1 ** t)
        return w - weak(lr, m) * m / (u + weak(1e-8, u)), (m, u)


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum and the momentum schedule
    ``beta1 * (1 - 0.5 * 0.96^(t * schedule_decay))``.  Its running
    product ``m_schedule`` lives on the host and advances once per call of
    the rule, as in JAX, so it is not fused-safe: the `Trainer` runs it
    per parameter and `parallel.TrainStep` refuses it (JAX's jitted step
    would trace the product once)."""
    fused_safe = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, weight, dtype=None):
        return (torch.zeros_like(weight, dtype=dtype),
                torch.zeros_like(weight, dtype=dtype))

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + weak(hp["wd"], w) * w
        m, v = s
        t = hp["t"]
        b1, b2 = self.beta1, self.beta2
        momentum_t = b1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t1 = b1 * (1 - 0.5 * 0.96 **
                            ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t1
        g_prime = g / weak(1 - self.m_schedule, g)
        m = weak(b1, m) * m + weak(1 - b1, g) * g
        v = weak(b2, v) * v + weak(1 - b2, g) * g * g
        m_prime = m / weak(1 - m_schedule_next, m)
        v_prime = v / weak(1 - b2 ** t, v)
        m_bar = weak(1 - momentum_t, g_prime) * g_prime + \
            weak(momentum_t1, m_prime) * m_prime
        return w - weak(hp["lr"], m_bar) * m_bar / (
            sqrt(v_prime) + weak(self.epsilon, v_prime)), (m, v)


@register
class AdaDelta(Optimizer):
    """AdaDelta: the step ``sqrt(acc_delta + eps) / sqrt(acc_g + eps) * g``
    from the old ``acc_delta`` and the new ``acc_g``, scaled by lr."""
    fused_elementwise = True

    def __init__(self, learning_rate=1.0, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, weight, dtype=None):
        return (torch.zeros_like(weight, dtype=dtype),
                torch.zeros_like(weight, dtype=dtype))

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + weak(hp["wd"], w) * w
        acc_g, acc_delta = s
        rho, eps = self.rho, self.epsilon
        acc_g = weak(rho, acc_g) * acc_g + weak(1 - rho, g) * g * g
        delta = sqrt(acc_delta + weak(eps, acc_delta)) / \
            sqrt(acc_g + weak(eps, acc_g)) * g
        acc_delta = weak(rho, acc_delta) * acc_delta + \
            weak(1 - rho, delta) * delta * delta
        return w - weak(hp["lr"], delta) * delta, (acc_g, acc_delta)


@register
class FTML(Optimizer):
    """Follow the moving leader: three states ``(d, v, z)``; the new weight
    is ``-z / d`` with ``d = (1 - beta1^t) / lr * (sqrt(v / (1 - beta2^t))
    + eps)``."""
    fused_elementwise = True

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, weight, dtype=None):
        return tuple(torch.zeros_like(weight, dtype=dtype) for _ in range(3))

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + weak(hp["wd"], w) * w
        d, v, z = s
        t = hp["t"]
        b1, b2 = self.beta1, self.beta2
        v = weak(b2, v) * v + weak(1 - b2, g) * g * g
        vb = v / weak(1 - b2 ** t, v)
        d_t = weak((1 - b1 ** t) / hp["lr"], vb) * (
            sqrt(vb) + weak(self.epsilon, vb))
        sigma = d_t - weak(b1, d) * d
        z = weak(b1, z) * z + weak(1 - b1, g) * g - sigma * w
        return -z / d_t, (d_t, v, z)
