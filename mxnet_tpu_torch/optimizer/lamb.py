"""LAMB, the layer-wise adaptive large-batch optimizer of BERT pretraining
(counterpart of ``mxnet_tpu/optimizer/lamb.py`` ``LAMB``, parity with
MXNet's ``multi_lamb.cc``).  LANS waits for a later slice (ROADMAP.md)."""
from __future__ import annotations

import torch

from .optimizer import Optimizer, register, weak


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
        r = mhat / (torch.sqrt(vhat) + self.epsilon) + hp["wd"] * w
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
