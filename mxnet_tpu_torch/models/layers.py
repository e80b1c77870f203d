"""Shared transformer building blocks (counterpart of
``mxnet_tpu/models/layers.py``): the fused-QKV self-attention and the
position-wise FFN as `nn.Module`s with the JAX package's child names
(``attn_qkv``, ``attn_proj``, ``ffn_intermediate``, ``ffn_output``), so
parameter names carry across one for one (`convert.load_jax_params`), plus
the Gluon layers they are built from (`Dense`, `Embedding`, `LayerNorm`,
`RMSNorm`, `Dropout`).

Their full-sequence ``forward`` is the training path: attention through
`ops.multi_head_attention` (the flash kernels on the card) and the FFN
with the erf GELU of ``npx.gelu``.  The serving slice reads the same
weights through the decode core (`serve.decode`), whose FFN keeps the
tanh GELU of the JAX decode step (``mxnet_tpu/serve/decode.py:261``).

Dropout draws from an explicit `torch.Generator` held by each `Dropout`
module (`attach_generator` shares one across a model); attention dropout
draws its kernel seed from the generator of the attention's output
`Dropout`, so one seed fixes every mask of a step.
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError
from ..ops import nn as F
from ..ops.attention import multi_head_attention

__all__ = ["Dense", "Embedding", "LayerNorm", "RMSNorm", "Dropout",
           "FusedSelfAttention", "FeedForward", "attach_generator",
           "check_max_position"]


def check_max_position(seq_len: int, max_position: int) -> None:
    """An out-of-range position would silently reuse the last position
    embedding — raise instead."""
    if seq_len > max_position:
        raise MXNetError(
            f"sequence length {seq_len} exceeds max_position "
            f"{max_position}; raise the config's max_position (position "
            "embeddings would silently clip)")


class Dense(nn.Linear):
    """Gluon ``nn.Dense(flatten=False)``: weight (units, in_units), the
    product in the promoted dtype of input and weight
    (`ops.nn.fully_connected`)."""

    def forward(self, x):
        return F.fully_connected(x, self.weight, self.bias)


class Embedding(nn.Embedding):
    """Gluon ``nn.Embedding``: out-of-range ids clip to the table."""

    def forward(self, ids):
        return F.embedding(ids, self.weight)


def _check_channels(layer, x, c):
    if x.shape[-1] != c:
        raise MXNetError(f"{layer}: input last axis has size {x.shape[-1]}, "
                         f"expected {c}")


class LayerNorm(nn.Module):
    """LayerNorm over the last axis under the JAX package's parameter
    names (``gamma``, ``beta``).  Gluon's LayerNorm keeps f32 parameters
    whatever the model's dtype, so the default `dtype` is f32.  The
    ``norm`` attribute is the function it calls, `ops.nn.layer_norm` (the
    fused row kernel on the card), and ``norm_residual`` the pre-LN step
    `residual` calls, `ops.nn.layer_norm_residual`; an oracle model swaps
    in `ops.fused_norm.fused_layer_norm_reference` and
    `fused_layer_norm_residual_reference`, the kernel route on its plain
    version."""

    def __init__(self, hidden_size: int, dtype=None, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.norm = F.layer_norm
        self.norm_residual = F.layer_norm_residual
        self.gamma = nn.Parameter(torch.ones(hidden_size, dtype=dtype))
        self.beta = nn.Parameter(torch.zeros(hidden_size, dtype=dtype))

    def forward(self, x):
        _check_channels("LayerNorm", x, self.gamma.shape[0])
        return self.norm(x, self.gamma, self.beta, eps=self.eps)

    def residual(self, x, residual):
        """``s = residual + x; y = LN(s)`` in one pass; returns ``(y,
        s)``."""
        _check_channels("LayerNorm", x, self.gamma.shape[0])
        return self.norm_residual(x, residual, self.gamma, self.beta,
                                  eps=self.eps)


class RMSNorm(nn.Module):
    """Root-mean-square norm over the last axis, ``y = x * rsqrt(mean(x^2)
    + eps) * gamma`` (Gluon ``nn.RMSNorm``: eps 1e-6, parameter ``gamma``).
    ``norm`` is `ops.nn.rms_norm`; an oracle swaps in
    `ops.fused_norm.fused_rms_norm_reference`."""

    def __init__(self, hidden_size: int, dtype=None, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.norm = F.rms_norm
        self.gamma = nn.Parameter(torch.ones(hidden_size, dtype=dtype))

    def forward(self, x):
        _check_channels("RMSNorm", x, self.gamma.shape[0])
        return self.norm(x, self.gamma, eps=self.eps)


class Dropout(nn.Module):
    """Gluon ``nn.Dropout`` with an explicit generator (None: the device's
    default); active in training mode only."""

    def __init__(self, rate: float, generator=None):
        super().__init__()
        self.rate = float(rate)
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.rate, generator=self.generator,
                         training=self.training)


def attach_generator(module: nn.Module, generator) -> None:
    """Give every `Dropout` inside `module` the one `generator`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class FusedSelfAttention(nn.Module):
    """softmax(QK^T)V with a single fused ``[q | k | v]`` projection (one
    even under GQA), attention-probs dropout (`attn_dropout`, default the
    output rate) inside the flash kernel, and output dropout.  The
    ``attend`` attribute is the multi-head attention it calls,
    `multi_head_attention`; an oracle model swaps in
    `multi_head_attention_reference`, which runs the flash kernels' plain
    versions on any device."""

    def __init__(self, hidden_size: int, num_heads: int,
                 dropout: float = 0.0, causal: bool = False, dtype=None,
                 attn_dropout=None, window=None, rope_theta=None,
                 num_kv_heads=None):
        super().__init__()
        if num_kv_heads is not None and num_heads % num_kv_heads:
            raise ValueError(f"num_heads ({num_heads}) must be divisible "
                             f"by num_kv_heads ({num_kv_heads})")
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.causal = causal
        self.window = window
        self.rope_theta = rope_theta
        self.attend = multi_head_attention
        self._attn_dropout = dropout if attn_dropout is None else attn_dropout
        self._kv_width = (num_kv_heads or num_heads) * (hidden_size //
                                                        num_heads)
        self.attn_qkv = Dense(hidden_size, hidden_size + 2 * self._kv_width,
                              dtype=dtype)
        self.attn_proj = Dense(hidden_size, hidden_size, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x, mask=None):
        qkv = self.attn_qkv(x)
        h = qkv.shape[-1] - 2 * self._kv_width
        kw = self._kv_width
        q, k, v = qkv[..., :h], qkv[..., h:h + kw], qkv[..., h + kw:]
        ctx = self.attend(
            q, k, v, self.num_heads, mask=mask,
            dropout_p=self._attn_dropout, causal=self.causal,
            window=self.window, rope_theta=self.rope_theta,
            num_kv_heads=self.num_kv_heads, training=self.training,
            generator=self.dropout.generator)
        return self.dropout(self.attn_proj(ctx))


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh,
                "softrelu": torch.nn.functional.softplus}


class FeedForward(nn.Module):
    """Position-wise FFN: proj-up, activation (the erf GELU of
    ``npx.gelu`` by default), proj-down, dropout."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 dropout: float = 0.0, activation: str = "gelu",
                 dtype=None):
        super().__init__()
        if activation != "gelu" and activation not in _ACTIVATIONS:
            raise MXNetError(f"FeedForward activation {activation!r} is not "
                             f"ported; use 'gelu' or one of "
                             f"{sorted(_ACTIVATIONS)}")
        self.ffn_intermediate = Dense(hidden_size, intermediate_size,
                                      dtype=dtype)
        self.ffn_output = Dense(intermediate_size, hidden_size, dtype=dtype)
        self.dropout = Dropout(dropout)
        self._act = activation

    def forward(self, x):
        y = self.ffn_intermediate(x)
        y = F.gelu(y) if self._act == "gelu" else _ACTIVATIONS[self._act](y)
        return self.dropout(self.ffn_output(y))
