"""Shared transformer building blocks (counterpart of
``mxnet_tpu/models/layers.py``): the fused-QKV self-attention and the
position-wise FFN as `nn.Module`s with the JAX package's child names
(``attn_qkv``, ``attn_proj``, ``ffn_intermediate``, ``ffn_output``), so
parameter names carry across one for one (`convert.load_jax_params`).

The serving slice reads their weights through the decode core
(`serve.decode`); their full-sequence ``forward`` reaches the
flash-attention and fused-norm kernels in JAX and waits for the training
slice (ROADMAP.md).
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError

__all__ = ["FusedSelfAttention", "FeedForward", "LayerNorm",
           "check_max_position"]


def check_max_position(seq_len: int, max_position: int) -> None:
    """An out-of-range position would silently reuse the last position
    embedding — raise instead."""
    if seq_len > max_position:
        raise MXNetError(
            f"sequence length {seq_len} exceeds max_position "
            f"{max_position}; raise the config's max_position (position "
            "embeddings would silently clip)")


def _not_ported(name):
    raise MXNetError(
        f"{name}.forward (the full-sequence path) is not ported to "
        "mxnet_tpu_torch yet — it waits for the training slice "
        "(ROADMAP.md); serve through mxnet_tpu_torch.serve or "
        "GPTForCausalLM.generate")


class LayerNorm(nn.Module):
    """Parameters of a LayerNorm under the JAX package's names
    (``gamma``, ``beta``); the decode core applies them."""

    def __init__(self, hidden_size: int, dtype=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(hidden_size, dtype=dtype))
        self.beta = nn.Parameter(torch.zeros(hidden_size, dtype=dtype))

    def forward(self, x):
        _not_ported("LayerNorm")


class FusedSelfAttention(nn.Module):
    """softmax(QK^T)V with a single fused ``[q | k | v]`` projection (one
    even under GQA)."""

    def __init__(self, hidden_size: int, num_heads: int, num_kv_heads=None,
                 dtype=None):
        super().__init__()
        if num_kv_heads is not None and num_heads % num_kv_heads:
            raise ValueError(f"num_heads ({num_heads}) must be divisible "
                             f"by num_kv_heads ({num_kv_heads})")
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        kv_width = (num_kv_heads or num_heads) * (hidden_size // num_heads)
        self.attn_qkv = nn.Linear(hidden_size, hidden_size + 2 * kv_width,
                                  dtype=dtype)
        self.attn_proj = nn.Linear(hidden_size, hidden_size, dtype=dtype)

    def forward(self, x, mask=None):
        _not_ported("FusedSelfAttention")


class FeedForward(nn.Module):
    """Position-wise FFN: proj-up, tanh-approximate GELU, proj-down."""

    def __init__(self, hidden_size: int, intermediate_size: int, dtype=None):
        super().__init__()
        self.ffn_intermediate = nn.Linear(hidden_size, intermediate_size,
                                          dtype=dtype)
        self.ffn_output = nn.Linear(intermediate_size, hidden_size,
                                    dtype=dtype)

    def forward(self, x):
        _not_ported("FeedForward")
