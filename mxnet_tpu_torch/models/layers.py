"""Shared transformer building blocks (counterpart of
``mxnet_tpu/models/layers.py``): the fused-QKV self-attention and the
position-wise FFN as Gluon `HybridBlock`s built from `gluon.nn` layers,
with the JAX package's child names (``attn_qkv``, ``attn_proj``,
``ffn_intermediate``, ``ffn_output``, ``dropout``), so parameter names
carry across one for one (`collect_params`, `load_parameters`,
`convert.load_jax_params`).

Their full-sequence ``forward`` is the training path: attention through
`ops.multi_head_attention` (the flash kernels on the card) and the FFN
with the erf GELU of ``npx.gelu``.  The serving slice reads the same
weights through the decode core (`serve.decode`), whose FFN keeps the
tanh GELU of the JAX decode step (``mxnet_tpu/serve/decode.py:261``).

Dropout is on only under `autograd.is_training` (inside ``record()`` or
``train_mode()``), as in JAX.  A model gives every `gluon.nn.Dropout` of
its tree one seeded ``torch.Generator`` (`attach_generator`); the
attention draws its kernel seed from the generator of its output
dropout, so one seed fixes every mask of a step.

Plain twins: the attention keeps the function it calls in ``_attend``
(`multi_head_attention`), `gluon.nn.LayerNorm` its norms in ``_norm`` and
``_norm_residual`` and `gluon.nn.RMSNorm` in ``_norm``.  `_plain_twin`
points them at the kernels' plain versions
(`multi_head_attention_reference`, `ops.fused_norm`'s
``fused_*_reference``): the same model, no kernel launched, on any
device -- what a card run is held against.
"""
from __future__ import annotations

import torch

from .. import autograd as _ag
from .. import random as _rng
from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ops import nn as F
from ..ops.attention import multi_head_attention

__all__ = ["FusedSelfAttention", "FeedForward", "attach_generator",
           "check_max_position"]


def check_max_position(seq_len: int, max_position: int) -> None:
    """An out-of-range position would silently reuse the last position
    embedding — raise instead."""
    if seq_len > max_position:
        raise MXNetError(
            f"sequence length {seq_len} exceeds max_position "
            f"{max_position}; raise the config's max_position (position "
            "embeddings would silently clip)")


def attach_generator(block, generator) -> None:
    """Give every `gluon.nn.Dropout` inside `block` the one `generator`."""
    for m in block.modules():
        if isinstance(m, nn.Dropout):
            m.generator = generator


def _seeded_fill(block, seed: int, device, draw=None) -> None:
    """Fill every parameter of `block` from a CPU generator seeded with
    `seed`, in `collect_params` order, then place it on `device`: unit
    LayerNorm gains, zero biases and betas, and ``draw(shape, generator)``
    (f32; default N(0, 0.02)) rounded to each parameter's dtype for the
    rest -- the same values on every device.  An uninitialized parameter
    is made on `device`; an initialized one is overwritten in place."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    if draw is None:
        def draw(shape, g):
            return torch.randn(shape, generator=g) * 0.02
    with torch.no_grad():
        for name, p in block.collect_params().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                v = torch.ones(p.shape, dtype=p.dtype)
            elif leaf in ("beta", "bias"):
                v = torch.zeros(p.shape, dtype=p.dtype)
            else:
                v = draw(p.shape, gen).to(p.dtype)
            if p._data is None:
                p._install(v.to(device))
            else:
                p._data.copy_(v)


def _plain_twin(model, norms=True, norm=None):
    """Point every attention of `model` at `multi_head_attention_reference`
    and, with `norms`, every LayerNorm at `norm` (default the fused norm's
    plain version) and its residual step at
    `fused_layer_norm_residual_reference`, every RMSNorm at
    `fused_rms_norm_reference`.  Returns `model`."""
    from ..ops import fused_norm as fn
    from ..ops.attention import multi_head_attention_reference
    for m in model.modules():
        if hasattr(m, "_attend"):
            m._attend = multi_head_attention_reference
        if not norms:
            continue
        if isinstance(m, nn.LayerNorm):
            m._norm = norm or fn.fused_layer_norm_reference
            m._norm_residual = fn.fused_layer_norm_residual_reference
        elif isinstance(m, nn.RMSNorm):
            m._norm = fn.fused_rms_norm_reference
    return model


def _generator_of(dropout, x):
    """The generator `dropout` draws from on `x`'s device."""
    g = dropout.generator
    return g if g is not None else _rng.generator(x.device)


class FusedSelfAttention(HybridBlock):
    """softmax(QK^T)V with a single fused ``[q | k | v]`` projection (one
    even under GQA), attention-probs dropout (`attn_dropout`, default the
    output rate) inside the flash kernel, and output dropout."""

    def __init__(self, hidden_size: int, num_heads: int,
                 dropout: float = 0.0, causal: bool = False,
                 dtype="float32", attn_dropout=None, window=None,
                 rope_theta=None, num_kv_heads=None):
        super().__init__()
        if num_kv_heads is not None and num_heads % num_kv_heads:
            raise ValueError(f"num_heads ({num_heads}) must be divisible "
                             f"by num_kv_heads ({num_kv_heads})")
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.causal = causal
        self.window = window
        self.rope_theta = rope_theta
        self._attend = multi_head_attention
        self._attn_dropout = dropout if attn_dropout is None else attn_dropout
        self._kv_width = (num_kv_heads or num_heads) * (hidden_size //
                                                        num_heads)
        self.attn_qkv = nn.Dense(hidden_size + 2 * self._kv_width,
                                 in_units=hidden_size, flatten=False,
                                 dtype=dtype)
        self.attn_proj = nn.Dense(hidden_size, in_units=hidden_size,
                                  flatten=False, dtype=dtype)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        qkv = self.attn_qkv(x)
        h = qkv.shape[-1] - 2 * self._kv_width
        kw = self._kv_width
        q, k, v = qkv[..., :h], qkv[..., h:h + kw], qkv[..., h + kw:]
        ctx = self._attend(
            q, k, v, self.num_heads, mask=mask,
            dropout_p=self._attn_dropout, causal=self.causal,
            window=self.window, rope_theta=self.rope_theta,
            num_kv_heads=self.num_kv_heads, training=_ag.is_training(),
            generator=_generator_of(self.dropout, x))
        return self.dropout(self.attn_proj(ctx))


_ACTIVATIONS = ("relu", "sigmoid", "tanh", "softrelu")


class FeedForward(HybridBlock):
    """Position-wise FFN: proj-up, activation (the erf GELU of
    ``npx.gelu`` by default), proj-down, dropout."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 dropout: float = 0.0, activation: str = "gelu",
                 dtype="float32"):
        super().__init__()
        if activation != "gelu" and activation not in _ACTIVATIONS:
            raise MXNetError(f"FeedForward activation {activation!r} is not "
                             f"ported; use 'gelu' or one of "
                             f"{sorted(_ACTIVATIONS)}")
        self.ffn_intermediate = nn.Dense(intermediate_size,
                                         in_units=hidden_size,
                                         flatten=False, dtype=dtype)
        self.ffn_output = nn.Dense(hidden_size, in_units=intermediate_size,
                                   flatten=False, dtype=dtype)
        self.dropout = nn.Dropout(dropout)
        self._act = activation

    def forward(self, x):
        y = self.ffn_intermediate(x)
        y = F.gelu(y) if self._act == "gelu" else \
            F.activation(y, act_type=self._act)
        return self.dropout(self.ffn_output(y))
