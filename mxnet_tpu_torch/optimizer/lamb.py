"""LAMB, the layer-wise adaptive large-batch optimizer of BERT pretraining,
and LANS (counterparts of ``mxnet_tpu/optimizer/lamb.py``, parity with
MXNet's ``multi_lamb.cc`` and ``multi_lans.cc``).  LAMB has its CUDA
kernels (`ops.fused_optimizer`); LANS runs leaf by leaf, as in JAX, whose
kernels take ``type(opt) is LAMB`` only."""
from __future__ import annotations

import torch

from .optimizer import Optimizer, register, sqrt, weak


@register
class LAMB(Optimizer):
    """Adam moments, then the update ``r = mhat / (sqrt(vhat) + eps) + wd *
    w`` scaled per tensor by the trust ratio ``||w|| / ||r||`` (``||w||``
    clipped to [lower_bound, upper_bound] when given; 1 where either norm
    is 0).  Not elementwise: `ops.fused_optimizer` reduces the norms per
    tensor (phase A, one launch a dtype group) before the update (phase B,
    one launch a tensor).

    The trust ratio is rounded to the weight's stored dtype, as JAX's rule
    rounds it (``ratio.astype(w.dtype)``).  The rule runs on f32 views of a
    16-bit weight, so the reference route names the stored dtype in
    ``hp["stored_dtype"]``; without that key (the kernels' plain version)
    the ratio stays in the view's f32, as in the CUDA kernels and JAX's."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, weight, dtype=None):
        return (torch.zeros_like(weight, dtype=dtype),
                torch.zeros_like(weight, dtype=dtype))

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp)
        m, v = s
        t = hp["t"]
        m = weak(self.beta1, m) * m + (1 - self.beta1) * g
        v = weak(self.beta2, v) * v + (1 - self.beta2) * g * g
        if self.bias_correction:
            mhat = m / (1 - self.beta1 ** t)
            vhat = v / (1 - self.beta2 ** t)
        else:
            mhat, vhat = m, v
        r = mhat / (sqrt(vhat) + self.epsilon) + hp["wd"] * w
        w_norm = torch.linalg.vector_norm(w.float())
        r_norm = torch.linalg.vector_norm(r.float())
        if self.lower_bound is not None:
            w_norm = torch.clamp(w_norm, min=self.lower_bound)
        if self.upper_bound is not None:
            w_norm = torch.clamp(w_norm, max=self.upper_bound)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        ratio = ratio.to(hp.get("stored_dtype", w.dtype))
        return w - hp["lr"] * ratio * r, (m, v)


def _trust(w, r, lower, upper):
    """``||w|| / ||r||`` in f32 (``||w||`` clipped to [lower, upper] when
    given; 1 where either norm is 0)."""
    w_norm = torch.linalg.vector_norm(w.float())
    r_norm = torch.linalg.vector_norm(r.float())
    if lower is not None:
        w_norm = torch.clamp(w_norm, min=lower)
    if upper is not None:
        w_norm = torch.clamp(w_norm, max=upper)
    return torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)


@register
class LANS(Optimizer):
    """LAMB with the gradient normalised per tensor and a Nesterov-style
    blend: ``beta1 * trust(r1) * r1 + (1 - beta1) * trust(r2) * r2`` with
    ``r1 = mhat / (sqrt(vhat) + eps) + wd * w`` and ``r2 = g / (sqrt(vhat)
    + eps) + wd * w``.  The trust ratios round to the weight's stored dtype
    (``hp["stored_dtype"]`` on the reference route), as JAX's do."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound

    def create_state(self, weight, dtype=None):
        return (torch.zeros_like(weight, dtype=dtype),
                torch.zeros_like(weight, dtype=dtype))

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp)
        g_norm = torch.linalg.vector_norm(g.float()).to(g.dtype)
        g = torch.where(g_norm > 0, g / g_norm, g)
        m, v = s
        t = hp["t"]
        b1, b2 = self.beta1, self.beta2
        m = weak(b1, m) * m + weak(1 - b1, g) * g
        v = weak(b2, v) * v + weak(1 - b2, g) * g * g
        mhat = m / weak(1 - b1 ** t, m)
        vhat = v / weak(1 - b2 ** t, v)
        sq = sqrt(vhat) + weak(self.epsilon, vhat)
        wd_w = weak(hp["wd"], w) * w
        r1 = mhat / sq + wd_w
        r2 = g / sq + wd_w
        dt = hp.get("stored_dtype", w.dtype)
        t1 = _trust(w, r1, self.lower_bound, self.upper_bound).to(dt)
        t2 = _trust(w, r2, self.lower_bound, self.upper_bound).to(dt)
        update = weak(b1, t1) * t1 * r1 + weak(1 - b1, t2) * t2 * r2
        return w - weak(hp["lr"], update) * update, (m, v)
