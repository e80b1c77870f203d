"""Transformer encoder-decoder for sequence-to-sequence translation
(counterpart of ``mxnet_tpu/models/transformer.py``).

Pre-LN blocks over the shared fused-QKV self-attention (`layers`): the
encoder attends its source under a key-padding mask from
``src_valid_length``, the decoder causally over its target, and each
decoder layer attends the encoder's output through `_CrossAttention`
(separate query and key/value projections, Lq != Lk).  Every attention
runs through `ops.multi_head_attention`, so on the card all three reach
the flash kernels; the norms reach the fused norm kernel and the loss of
`ops.softmax_cross_entropy` the cross-entropy kernels.

Every class is a Gluon `HybridBlock` built from `gluon.nn` with the JAX
package's parameter names (``encoder.embed.word_embed.weight``,
``decoder.layers.<i>.cross_attention.attn_kv.weight``, ``proj.weight``,
…), so `load_parameters` and `convert.load_jax_params` fill it name for
name.  LayerNorm
parameters stay f32 in a bf16 or f16 model, as Gluon keeps them.
"""
from __future__ import annotations

import torch

from .. import autograd as _ag
from ..device import resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import accepts_ndarray
from ..ops.attention import multi_head_attention
from .gpt import torch_dtype
from .layers import (FeedForward, FusedSelfAttention, _seeded_fill,
                     attach_generator, check_max_position)

__all__ = ["TransformerConfig", "TransformerEncoder", "TransformerDecoder",
           "TransformerNMT", "transformer_base"]


class TransformerConfig:
    def __init__(self, src_vocab_size=32000, tgt_vocab_size=32000,
                 hidden_size=512, num_layers=6, num_heads=8,
                 intermediate_size=2048, max_position=1024, dropout=0.1,
                 layer_norm_eps=1e-5, dtype="float32"):
        self.src_vocab_size = src_vocab_size
        self.tgt_vocab_size = tgt_vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.dtype = dtype


def transformer_base(**kwargs):
    """Vaswani et al. 2017, Table 3 "base": d_model 512, 6 + 6 layers, 8
    heads, d_ff 2048; vocabularies of 32000 each side."""
    return TransformerConfig(**kwargs)


class _CrossAttention(HybridBlock):
    """Cross-attention over encoder memory: separate query and key/value
    projections, no attention-probs dropout (as JAX).  ``_attend`` is
    `multi_head_attention` (a plain twin's `multi_head_attention_reference`,
    `layers._plain_twin`)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self._attend = multi_head_attention
        self.attn_query = nn.Dense(h, in_units=h, flatten=False, dtype=dt)
        self.attn_kv = nn.Dense(2 * h, in_units=h, flatten=False, dtype=dt)
        self.attn_proj = nn.Dense(h, in_units=h, flatten=False, dtype=dt)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x, memory, mask=None):
        q = self.attn_query(x)
        kv = self.attn_kv(memory)
        h = kv.shape[-1] // 2
        ctx = self._attend(q, kv[..., :h], kv[..., h:], self.num_heads,
                           mask=mask)
        return self.dropout(self.attn_proj(ctx))


class _EncoderLayer(HybridBlock):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attn_norm = nn.LayerNorm(epsilon=eps, in_channels=h)
        self.attention = FusedSelfAttention(h, cfg.num_heads,
                                            dropout=cfg.dropout, dtype=dt)
        self.ffn_norm = nn.LayerNorm(epsilon=eps, in_channels=h)
        self.ffn = FeedForward(h, cfg.intermediate_size,
                               dropout=cfg.dropout, activation="relu",
                               dtype=dt)

    def forward(self, x, mask=None):
        x = x + self.attention(self.attn_norm(x), mask=mask)
        return x + self.ffn(self.ffn_norm(x))


class _DecoderLayer(HybridBlock):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attn_norm = nn.LayerNorm(epsilon=eps, in_channels=h)
        self.attention = FusedSelfAttention(h, cfg.num_heads,
                                            dropout=cfg.dropout, causal=True,
                                            dtype=dt)
        self.cross_norm = nn.LayerNorm(epsilon=eps, in_channels=h)
        self.cross_attention = _CrossAttention(cfg)
        self.ffn_norm = nn.LayerNorm(epsilon=eps, in_channels=h)
        self.ffn = FeedForward(h, cfg.intermediate_size,
                               dropout=cfg.dropout, activation="relu",
                               dtype=dt)

    def forward(self, x, memory, memory_mask=None):
        x = x + self.attention(self.attn_norm(x))
        x = x + self.cross_attention(self.cross_norm(x), memory,
                                     mask=memory_mask)
        return x + self.ffn(self.ffn_norm(x))


class _Embedding(HybridBlock):
    """Token embedding scaled by sqrt(hidden) plus learned positions."""

    def __init__(self, cfg: TransformerConfig, vocab: int):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        self.scale = float(cfg.hidden_size) ** 0.5
        self._max_position = cfg.max_position
        self.word_embed = nn.Embedding(vocab, cfg.hidden_size, dtype=dt)
        self.position_embed = nn.Embedding(cfg.max_position,
                                           cfg.hidden_size, dtype=dt)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, ids):
        b, l = ids.shape
        check_max_position(l, self._max_position)
        pos = torch.arange(l, device=ids.device).reshape(1, l)
        x = self.word_embed(ids) * self.scale + self.position_embed(pos)
        return self.dropout(x)


class TransformerEncoder(HybridBlock):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.embed = _Embedding(cfg, cfg.src_vocab_size)
        self.layers = nn.HybridSequential()
        for _ in range(cfg.num_layers):
            self.layers.add(_EncoderLayer(cfg))
        self.final_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps,
                                       in_channels=cfg.hidden_size)

    def forward(self, src_ids, src_valid_length=None):
        """(memory (B, L, E), mask): the mask is (B, 1, 1, L) boolean,
        True on the first ``src_valid_length`` keys of each row, or None."""
        b, l = src_ids.shape
        mask = None
        if src_valid_length is not None:
            vl = torch.as_tensor(src_valid_length, device=src_ids.device)
            steps = torch.arange(l, device=src_ids.device)
            mask = steps.reshape(1, 1, 1, l) < vl.reshape(b, 1, 1, 1)
        x = self.embed(src_ids)
        for layer in self.layers:
            x = layer(x, mask)
        return self.final_norm(x), mask


class TransformerDecoder(HybridBlock):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.embed = _Embedding(cfg, cfg.tgt_vocab_size)
        self.layers = nn.HybridSequential()
        for _ in range(cfg.num_layers):
            self.layers.add(_DecoderLayer(cfg))
        self.final_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps,
                                       in_channels=cfg.hidden_size)

    def forward(self, tgt_ids, memory, memory_mask=None):
        x = self.embed(tgt_ids)
        for layer in self.layers:
            x = layer(x, memory, memory_mask)
        return self.final_norm(x)


class TransformerNMT(HybridBlock):
    """Full seq2seq model: encoder + causal decoder + projection.

    Construction initializes it, as `GPTForCausalLM`'s does: weights drawn
    on `device` (the card unless ``device="cpu"``) from `seed` — N(0,
    0.02) for matrices and embeddings, zero biases, unit LayerNorm gains,
    on the CPU generator so a seed gives the same weights on every device
    — and one dropout generator on `device`, also seeded from `seed`,
    shared by every dropout; ``initialize()`` after it is a no-op unless
    ``force_reinit=True``."""

    def __init__(self, cfg: TransformerConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = TransformerEncoder(cfg)
        self.decoder = TransformerDecoder(cfg)
        self.proj = nn.Dense(cfg.tgt_vocab_size, in_units=cfg.hidden_size,
                             use_bias=False, flatten=False,
                             dtype=torch_dtype(cfg.dtype))
        _seeded_fill(self, seed, dev)
        self.generator = torch.Generator(device=dev).manual_seed(int(seed))
        attach_generator(self, self.generator)

    @property
    def device(self) -> torch.device:
        return self.proj.weight.data().device

    def reset_parameters(self, seed: int = 0) -> None:
        """Draw every weight again from `seed`, as the constructor does."""
        _seeded_fill(self, seed, self.device)

    def forward(self, src_ids, tgt_ids, src_valid_length=None):
        """Logits (B, Lt, tgt_vocab) of the target given the source."""
        memory, mask = self.encoder(src_ids, src_valid_length)
        return self.proj(self.decoder(tgt_ids, memory, mask))

    @accepts_ndarray
    @torch.inference_mode()
    def greedy_translate(self, src_ids, bos_id=1, eos_id=2, max_len=32,
                         src_valid_length=None):
        """Greedy decode with the full target recomputed each step (dropout
        off), as JAX's eager ``greedy_translate``: (B, <= max_len) int32
        ids starting with `bos_id`; a finished row keeps emitting
        `eos_id`, and the loop stops once every row has finished."""
        with _ag.predict_mode():
            src = torch.as_tensor(src_ids, device=self.device)
            memory, mask = self.encoder(src, src_valid_length)
            b = src.shape[0]
            tgt = torch.full((b, 1), bos_id, dtype=torch.int32,
                             device=src.device)
            finished = torch.zeros(b, dtype=torch.bool, device=src.device)
            for _ in range(max_len - 1):
                logits = self.proj(self.decoder(tgt, memory, mask))[:, -1]
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
                nxt = torch.where(finished, eos_id, nxt).to(torch.int32)
                tgt = torch.cat([tgt, nxt[:, None]], dim=1)
                finished = finished | (nxt == eos_id)
                if bool(finished.all()):
                    break
            return tgt
