"""The ``numpy_extension`` ops on the BERT training path, in plain torch
(counterparts of ``mxnet_tpu/numpy_extension/__init__.py``).

Dtype flow follows the JAX package's, route for route, so a module
computes what its JAX counterpart computes.  The norms dispatch as
``npx.layer_norm`` does (`ops.policy`, ``MXTPU_PALLAS``): on the kernel
route (the default on the card) the fused row kernel returns x's dtype,
so a bf16 model stays bf16; on the reference route a bf16 activation
meeting an f32 LayerNorm gain comes out f32.  `fully_connected` multiplies
in the promoted type of its operands (``jnp.matmul`` promotes;
``torch.matmul`` would refuse).
Random ops take an explicit `torch.Generator` where the JAX package draws
from its global key.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import fused_norm as _fnorm
from .softmax_xent import softmax_cross_entropy as _xent

__all__ = ["layer_norm", "layer_norm_residual", "rms_norm",
           "rms_norm_residual", "gelu", "dropout", "embedding",
           "fully_connected", "pick", "softmax_cross_entropy"]


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm (``npx.layer_norm``) over `axis`.  The last axis goes
    through `fused_norm.fused_layer_norm`: the fused row kernel's route
    when `fused_norm.kernel_eligible` (the policy), else
    `fused_norm.layer_norm_reference`, mean and variance in the input
    dtype.  Another axis takes that reference math, moved last."""
    axis = axis % x.dim()
    if axis == x.dim() - 1:
        return _fnorm.fused_layer_norm(x, gamma, beta, eps=eps)
    y = _fnorm.layer_norm_reference(x.movedim(axis, -1), gamma, beta,
                                    eps=eps)
    return y.movedim(-1, axis)


def layer_norm_residual(x, residual, gamma, beta, axis=-1, eps=1e-5):
    """The pre-LN step ``s = residual + x; y = LN(s)``; returns ``(y, s)``
    (``npx.layer_norm_residual``).  Last axis only."""
    _fnorm._last_axis("layer_norm_residual", x, axis)
    return _fnorm.layer_norm_residual(x, residual, gamma, beta, eps=eps)


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    """RMSNorm over the last axis: ``y = x * rsqrt(mean(x^2) + eps) *
    gamma`` (``npx.rms_norm``)."""
    _fnorm._last_axis("rms_norm", x, axis)
    return _fnorm.fused_rms_norm(x, gamma, eps=eps)


def rms_norm_residual(x, residual, gamma, axis=-1, eps=1e-6):
    """``s = residual + x; y = RMSNorm(s)``; returns ``(y, s)``
    (``npx.rms_norm_residual``)."""
    _fnorm._last_axis("rms_norm_residual", x, axis)
    return _fnorm.rms_norm_residual(x, residual, gamma, eps=eps)


def gelu(x, approximation="erf"):
    """GELU; the erf form by default, as ``npx.gelu``.  ``"tanh"`` (or
    ``"fast"``) selects the tanh approximation."""
    if approximation in ("tanh", "fast"):
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def dropout(x, p=0.5, generator=None, training=True):
    """Inverted dropout: keep each element with probability ``1 - p``
    (drawn from `generator`, the device's default when None) and scale it
    by ``1 / (1 - p)``.  Identity unless `training` and ``p > 0``."""
    if not training or p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def embedding(ids, weight):
    """Row lookup; out-of-range ids clip to the table, as
    ``npx.embedding``'s ``mode="clip"`` does."""
    idx = torch.as_tensor(ids, device=weight.device).long().clamp(
        0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


def fully_connected(x, weight, bias=None):
    """``x @ weight.T + bias`` (``npx.fully_connected`` with
    ``flatten=False``; weight (units, in_units)) in the promoted dtype of
    the operands."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        dt = torch.promote_types(dt, bias.dtype)
    return F.linear(x.to(dt), weight.to(dt),
                    None if bias is None else bias.to(dt))


def pick(x, index, axis=-1, keepdims=False):
    """``x`` at `index` along `axis`, indices clipped into range
    (``npx.pick``, mode "clip")."""
    axis = axis % x.dim()
    idx = torch.as_tensor(index, device=x.device).long().clamp(
        0, x.shape[axis] - 1).unsqueeze(axis)
    out = torch.gather(x, axis, idx)
    return out if keepdims else out.squeeze(axis)


def softmax_cross_entropy(logits, labels, reduction="none"):
    """Sparse-label cross entropy over the last axis
    (``npx.softmax_cross_entropy``): the streaming kernel on the card
    (`ops.softmax_xent`).  ``reduction="sum"`` gives the summed (1,)
    output of the reference op."""
    loss = _xent(logits, labels)
    if reduction == "sum":
        return loss.sum().reshape(1)
    return loss
