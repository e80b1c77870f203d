"""Attention ops (counterpart of ``mxnet_tpu/ops/attention.py``).

`multi_head_attention` over projected (B, L, E) tensors splits heads and
calls `dot_product_attention`, which turns a boolean-style mask into the
flash kernel's additive bias and runs `flash_attention`: the hand-written
CUDA kernels on a CUDA tensor (or an error), the plain versions on a CPU
tensor.  There is no silent fallback to another attention.
`multi_head_attention_reference` is the same computation through
`flash_attention_reference` on any device: the oracle a run on the card is
held against.  `reference_attention` is the einsum-and-softmax path
(``use_flash=False``).  `rope_rotate` serves the cached decode step too.

Attention dropout takes a `torch.Generator` where the JAX package takes a
PRNG key: the flash path draws its int32 hash seed from it, the reference
path draws a Bernoulli mask.

Under `amp.init` the multi-head entry points cast query, key, value and a
float mask to the AMP dtype (``multi_head_attention`` is a TARGET op, as
in JAX), so the flash kernels run in f16 or bf16; the mask is 0/1, exact
in either, and becomes the kernels' f32 bias.
"""
from __future__ import annotations

import torch

from .. import amp as _amp
from ..base import MXNetError
from .flash_attention import (MASK_VALUE, flash_attention,
                              flash_attention_reference)

__all__ = ["multi_head_attention", "multi_head_attention_reference",
           "dot_product_attention", "reference_attention", "band_bias",
           "rope_rotate"]


def band_bias(lq, lk, window, causal=False, symmetric=True, device=None):
    """(1, 1, Lq, Lk) additive bias for sliding-window attention: 0 inside
    the band ([q-w, q+w] symmetric non-causal, else [q-w, q]), MASK_VALUE
    outside."""
    rows = torch.arange(lq, device=device)[:, None]
    cols = torch.arange(lk, device=device)[None, :]
    keep = cols >= rows - window
    if symmetric and not causal:
        keep &= cols <= rows + window
    else:
        keep &= cols <= rows
    return torch.where(keep, 0.0, MASK_VALUE).to(torch.float32)[None, None]


def reference_attention(q, k, v, mask=None, causal=False, scale=None,
                        logits_dtype=torch.float32, bias=None,
                        dropout_rate=0.0, dropout_generator=None):
    """softmax(QK^T/sqrt(d)) V over (B, H, Lq, D)/(B, H, Lk, D) tensors.

    Scores in `logits_dtype` (f32 for bf16 inputs).  `mask` is
    boolean-style (nonzero = keep) and broadcasts as given; `bias` is
    additive f32 and is aligned to rank 4 from the left ((B, Lk) ->
    (B, 1, 1, Lk)).  Rows with no unmasked key produce zeros.  Dropout
    applies when `dropout_rate` > 0 and a generator is given."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.matmul(q.to(logits_dtype),
                          k.to(logits_dtype).transpose(-1, -2)) * s
    masked = causal or mask is not None or bias is not None
    if bias is not None:
        bb = torch.as_tensor(bias).to(device=logits.device,
                                      dtype=logits.dtype)
        while bb.dim() < 4:
            bb = bb[:, None]
        logits = logits + bb
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        cm = torch.tril(torch.ones((lq, lk), dtype=torch.bool,
                                   device=logits.device), diagonal=lk - lq)
        logits = torch.where(cm, logits, MASK_VALUE)
    if mask is not None:
        logits = torch.where(torch.as_tensor(mask).bool(), logits,
                             MASK_VALUE)
    p = torch.softmax(logits, dim=-1)
    if masked:
        # fully masked rows: the softmax of all-MASK_VALUE logits is
        # uniform; zero them so the output (and its gradient) is zero
        p = torch.where(logits > 0.5 * MASK_VALUE, p, 0.0)
    if dropout_rate > 0.0 and dropout_generator is not None:
        keep = torch.rand(p.shape, generator=dropout_generator,
                          device=p.device) < 1.0 - dropout_rate
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    return torch.matmul(p.to(q.dtype), v)


def _mask_to_bias(mask):
    """Boolean-style attention mask (nonzero = keep) -> additive f32 bias."""
    m = torch.as_tensor(mask)
    return torch.where(m.bool(), 0.0, MASK_VALUE).to(torch.float32)


def _normalize_mask_4d(mask):
    """Expand the documented mask shapes to broadcast-correct
    (B, 1|H, 1|Lq, Lk): (B, Lk) -> (B, 1, 1, Lk); (B, 1|Lq, Lk) ->
    (B, 1, 1|Lq, Lk).  Right-aligned broadcasting would spread a (B, Lk)
    mask along the query axis of (B, H, Lq, Lk) logits — silently wrong
    when B == Lq."""
    m = torch.as_tensor(mask)
    while m.dim() < 4:
        m = m[:, None]
    return m


def _seed_from_generator(generator, device):
    """A scalar int32 kernel seed drawn from `generator` (the stand-in for
    ``_seed_from_key``); drawn on the generator's device, with no host
    sync on the card."""
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), dtype=torch.int32,
                         generator=generator, device=generator.device)
    return seed.to(device)


def _default_generator(device):
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    return torch.default_generator


def dot_product_attention(q, k, v, mask=None, causal=False, scale=None,
                          use_flash=True, dropout_rate=0.0,
                          dropout_generator=None, window=None,
                          window_symmetric=True):
    """Fused attention over (B, H, L, D) tensors.

    `mask` is boolean-style (nonzero = keep): (B, Lk), (B, 1|Lq, Lk) or
    (B, 1|H, 1|Lq, Lk); it streams into the flash kernel as an additive
    bias.  Dropout applies when `dropout_rate` > 0 and a generator is
    given.  k/v may carry g < H heads (H % g == 0).  ``use_flash=False``
    runs `reference_attention`."""
    return _dot_product_attention(flash_attention, q, k, v, mask, causal,
                                  scale, use_flash, dropout_rate,
                                  dropout_generator, window, window_symmetric)


def _dot_product_attention(flash, q, k, v, mask, causal, scale, use_flash,
                           dropout_rate, dropout_generator, window,
                           window_symmetric):
    """`dot_product_attention` with `flash` as its flash attention."""
    if mask is not None:
        mask = _normalize_mask_4d(mask)
    if k.shape[1] != q.shape[1] and (
            k.shape[1] == 0 or q.shape[1] % k.shape[1]):
        raise ValueError(f"query heads ({q.shape[1]}) must be a "
                         f"multiple of kv heads ({k.shape[1]})")
    drop = dropout_rate > 0.0 and dropout_generator is not None
    if use_flash:
        bias = _mask_to_bias(mask) if mask is not None else None
        seed = (_seed_from_generator(dropout_generator, q.device)
                if drop else None)
        return flash(q, k, v, causal=causal, scale=scale, bias=bias,
                     dropout_rate=dropout_rate if drop else 0.0,
                     dropout_seed=seed, window=window,
                     window_symmetric=window_symmetric)
    if k.shape[1] != q.shape[1]:   # the einsum path needs full heads
        rep = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    bias = None
    if window is not None:
        bias = band_bias(q.shape[2], k.shape[2], window, causal,
                         window_symmetric, device=q.device)
    return reference_attention(q, k, v, mask=mask, causal=causal,
                               scale=scale, bias=bias,
                               dropout_rate=dropout_rate if drop else 0.0,
                               dropout_generator=dropout_generator)


def rope_rotate(x, positions, theta: float = 10000.0):
    """Rotary position embedding (rotate-half form) over the last axis.

    x: (..., L, D) with D even; `positions` broadcasts against the L axis.
    The rotation arithmetic runs in f32 regardless of activation dtype —
    bf16 cos/sin tables would alias adjacent positions in the
    low-frequency bands at long context."""
    if x.shape[-1] % 2:
        raise ValueError(f"rope requires an even head_dim, got "
                         f"{x.shape[-1]}")
    d2 = x.shape[-1] // 2
    freq = theta ** (-torch.arange(d2, dtype=torch.float32,
                                   device=x.device) / d2)
    ang = torch.as_tensor(positions, device=x.device).float()[..., None] \
        * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1, x2 = xf[..., :d2], xf[..., d2:]
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def multi_head_attention(query, key, value, num_heads, mask=None,
                         dropout_p=0.0, causal=False, use_flash=True,
                         window=None, window_symmetric=True,
                         rope_theta=None, num_kv_heads=None, training=False,
                         generator=None):
    """Multi-head attention over projected (B, L, E) tensors.

    Attention-probs dropout `dropout_p` applies in training mode, from
    `generator` (the device's default generator when None).
    ``num_kv_heads=g`` is grouped-query attention: key/value carry g
    heads.  `rope_theta` rotates q and k (self-attention only)."""
    return _multi_head_attention(
        flash_attention, query, key, value, num_heads, mask, dropout_p,
        causal, use_flash, window, window_symmetric, rope_theta,
        num_kv_heads, training, generator)


def multi_head_attention_reference(query, key, value, num_heads, mask=None,
                                   dropout_p=0.0, causal=False,
                                   use_flash=True, window=None,
                                   window_symmetric=True, rope_theta=None,
                                   num_kv_heads=None, training=False,
                                   generator=None):
    """`multi_head_attention` through `flash_attention_reference`: the
    flash kernels' plain versions on any device, drawing the same dropout
    seeds from `generator`, with no kernel launched."""
    return _multi_head_attention(
        flash_attention_reference, query, key, value, num_heads, mask,
        dropout_p, causal, use_flash, window, window_symmetric, rope_theta,
        num_kv_heads, training, generator)


def _multi_head_attention(flash, query, key, value, num_heads, mask,
                          dropout_p, causal, use_flash, window,
                          window_symmetric, rope_theta, num_kv_heads,
                          training, generator):
    query, key, value, mask = _amp.cast_inputs(
        "multi_head_attention", query, key, value, mask)
    b, lq, e = query.shape
    lk = key.shape[1]
    hd = e // num_heads
    kvh = num_kv_heads or num_heads
    if num_heads % kvh:
        raise ValueError(f"num_heads ({num_heads}) must be divisible by "
                         f"num_kv_heads ({kvh})")
    qh = query.reshape(b, lq, num_heads, hd).transpose(1, 2)
    kh = key.reshape(b, lk, kvh, hd).transpose(1, 2)
    vh = value.reshape(b, lk, kvh, hd).transpose(1, 2)
    if rope_theta is not None:
        if lq != lk:
            raise MXNetError(
                "rope_theta requires self-attention (Lq == Lk): got "
                f"Lq={lq}, Lk={lk}; rotate q/k with rope_rotate instead")
        pos = torch.arange(lq, device=query.device)
        qh = rope_rotate(qh, pos, float(rope_theta))
        kh = rope_rotate(kh, pos, float(rope_theta))
    m = mask
    if m is not None and m.dim() == 3:     # (B, Lq, Lk) -> (B, 1, Lq, Lk)
        m = m[:, None]
    gen = None
    if dropout_p > 0.0 and training:
        gen = generator if generator is not None \
            else _default_generator(query.device)
    out = _dot_product_attention(
        flash, qh, kh, vh, m, causal, None, use_flash,
        dropout_p if gen is not None else 0.0, gen, window,
        window_symmetric)
    return out.transpose(1, 2).reshape(b, lq, e)
