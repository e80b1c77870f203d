"""Attention helpers of the decode core.

Only `rope_rotate` is ported so far (counterpart of
``mxnet_tpu/ops/attention.py:200``): the cached decode step calls it when
``cfg.rope`` is set.  The full-sequence attention op waits for the
training slice (ROADMAP.md).
"""
from __future__ import annotations

import torch

__all__ = ["rope_rotate"]


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
