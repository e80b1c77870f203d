"""The AdaGrad family (counterpart of ``mxnet_tpu/optimizer/adagrad.py``):
AdaGrad, GroupAdaGrad, RMSProp, Ftrl and the trivial ``Test`` optimizer,
the same rules with the same order of operations.  None is fused
elementwise: the fused routes run them leaf by leaf, as JAX's do.  Python
numbers beside a tensor go through `weak`."""
from __future__ import annotations

import torch

from .optimizer import Optimizer, register, sign, sqrt, weak


@register
class AdaGrad(Optimizer):
    """``hist += g^2``; ``w -= lr * g / (sqrt(hist) + eps)``."""

    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, weight, dtype=None):
        return (torch.zeros_like(weight, dtype=dtype),)

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + weak(hp["wd"], w) * w
        (hist,) = s
        hist = hist + g * g
        return w - weak(hp["lr"], g) * g / (
            sqrt(hist) + weak(self.epsilon, hist)), (hist,)


@register
class GroupAdaGrad(Optimizer):
    """Row-wise AdaGrad: one accumulator per row of the weight (state
    shaped ``(rows, 1, ...)``), fed the mean of ``g^2`` over the row."""

    def __init__(self, learning_rate=0.01, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, weight, dtype=None):
        shape = tuple(weight.shape[:1]) + (1,) * (weight.dim() - 1)
        return (torch.zeros(shape, dtype=dtype or weight.dtype,
                            device=weight.device),)

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp)
        (hist,) = s
        sq = g * g
        if g.dim() > 1:      # a mean over no axis is the value itself
            sq = torch.mean(sq, dim=tuple(range(1, g.dim())), keepdim=True)
        hist = hist + sq
        return w - weak(hp["lr"], g) * g / (
            sqrt(hist) + weak(self.epsilon, hist)), (hist,)


@register
class RMSProp(Optimizer):
    """RMSProp with momentum; ``centered`` keeps the mean gradient too
    (state ``(n, g_mean, delta)``, else ``(n, mom)``); ``clip_weights``
    clips the new weight."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum = rho, momentum
        self.epsilon, self.centered = epsilon, centered
        self.clip_weights = clip_weights

    def create_state(self, weight, dtype=None):
        k = 3 if self.centered else 2
        return tuple(torch.zeros_like(weight, dtype=dtype) for _ in range(k))

    def _clip(self, w):
        if self.clip_weights:
            w = torch.clamp(w, -self.clip_weights, self.clip_weights)
        return w

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + weak(hp["wd"], w) * w
        rho, mu, eps = self.rho, self.momentum, self.epsilon
        n = s[0]
        n = weak(rho, n) * n + weak(1 - rho, g) * g * g
        if self.centered:
            _, gm, delta = s
            gm = weak(rho, gm) * gm + weak(1 - rho, g) * g
            den = n - gm * gm
            delta = weak(mu, delta) * delta - weak(hp["lr"], g) * g / \
                sqrt(den + weak(eps, den))
            return self._clip(w + delta), (n, gm, delta)
        mom = s[1]
        mom = weak(mu, mom) * mom - weak(hp["lr"], g) * g / \
            sqrt(n + weak(eps, n))
        return self._clip(w + mom), (n, mom)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (proximal, L1 ``lamda1``): state
    ``(z, n)``; the weight is 0 where ``|z| <= lamda1``."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, weight, dtype=None):
        return (torch.zeros_like(weight, dtype=dtype),
                torch.zeros_like(weight, dtype=dtype))

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp)
        z, n = s
        lr = hp["lr"]
        n_new = n + g * g
        sigma = (sqrt(n_new) - sqrt(n)) / weak(lr, n_new)
        z = z + g - sigma * w
        root = sqrt(n_new)
        den = (weak(self.beta, root) + root) / weak(lr, root) + \
            weak(hp["wd"], root)
        sz = sign(z)
        num = -(z - sz * weak(self.lamda1, sz))
        w = torch.where(torch.abs(z) > self.lamda1, num / den,
                        0.0).to(w.dtype)
        return w, (z, n_new)


@register
class Test(Optimizer):
    """The trivial optimizer of MXNet's tests: ``w -= lr * (g + wd * w)``
    and a state ``(zeros,)`` that it keeps as it is."""

    def create_state(self, weight, dtype=None):
        return (torch.zeros_like(weight, dtype=dtype),)

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + weak(hp["wd"], w) * w
        return w - weak(hp["lr"], g) * g, tuple(s)
