"""The ``numpy_extension`` ops on the BERT training path, in plain torch
(counterparts of ``mxnet_tpu/numpy_extension/__init__.py``).

Dtype flow follows JAX's promotion rules, so a module computes what its
JAX counterpart computes: a bf16 activation meeting an f32 LayerNorm gain
comes out f32, and `fully_connected` multiplies in the promoted type of
its operands (``jnp.matmul`` promotes; ``torch.matmul`` would refuse).
Random ops take an explicit `torch.Generator` where the JAX package draws
from its global key.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .softmax_xent import softmax_cross_entropy as _xent

__all__ = ["layer_norm", "gelu", "dropout", "embedding", "fully_connected",
           "pick", "softmax_cross_entropy"]


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm with the math of ``npx.layer_norm`` and
    ``fused_norm.layer_norm_reference``: mean and variance in the input
    dtype, then ``(x - mean) * rsqrt(var + eps) * gamma + beta``."""
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps)
    shape = [1] * x.dim()
    shape[axis % x.dim()] = x.shape[axis % x.dim()]
    return y * gamma.reshape(shape) + beta.reshape(shape)


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
