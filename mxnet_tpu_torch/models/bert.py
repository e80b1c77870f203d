"""BERT for pretraining (counterpart of ``mxnet_tpu/models/bert.py``).

A post-LN encoder over the shared fused-QKV attention (`layers`), learned
positions and token types, the masked-LM head (optionally on the
``masked_positions`` slots only) and the next-sentence classifier, as
Gluon `HybridBlock`s built from `gluon.nn`.  The tree carries the JAX
package's parameter names (``bert.word_embed.weight``,
``bert.layers.<i>.attention.attn_qkv.weight``,
``bert.layers.<i>.ffn_norm.gamma``, ``mlm_decoder.weight``, …) and dtypes —
LayerNorm parameters stay f32 when the model is bf16 or f16, as Gluon
keeps them — so `load_parameters` and `convert.load_jax_params` fill it
name for name.

Attention runs through the flash kernels on the card (key padding from
``valid_length`` as a compact bias, attention-probs dropout inside the
kernel, and ``window``'s symmetric band [q - w, q + w] with the tiles
outside it skipped); the loss of `gluon.loss` / `ops.softmax_cross_entropy`
through the streaming cross-entropy kernels.  ``remat`` recomputes each
layer in the backward pass (`ops.nn.remat_call`).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ops import nn as F
from .gpt import torch_dtype
from .layers import (FusedSelfAttention, _seeded_fill, attach_generator,
                     check_max_position)

__all__ = ["BertConfig", "BertSelfAttention", "BertLayer", "BertModel",
           "BertForPretraining", "bert_base", "bert_large"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=512,
                 type_vocab_size=2, dropout=0.1, layer_norm_eps=1e-12,
                 dtype="float32", remat=False, window=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.dtype = dtype
        # recompute each layer's activations in backward: False/True or a
        # named policy (`ops.nn.resolve_remat_policy`; MXTPU_REMAT_POLICY
        # overrides)
        self.remat = remat
        # Longformer-style symmetric sliding-window attention, [q - w, q + w]
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window


def bert_base(**kwargs):
    """BERT-base: vocab 30522, hidden 768, 12 layers, 12 heads, FFN 3072,
    512 positions."""
    return BertConfig(**kwargs)


def bert_large(**kwargs):
    cfg = dict(hidden_size=1024, num_layers=24, num_heads=16,
               intermediate_size=4096)
    cfg.update(kwargs)
    return BertConfig(**cfg)


class BertSelfAttention(FusedSelfAttention):
    """The shared fused-QKV attention under BERT's older surface (JAX's
    shim): built from a `BertConfig` or from `FusedSelfAttention`'s own
    arguments, called with ``attn_mask=`` or ``mask=``."""

    def __init__(self, cfg_or_hidden, *args, **kwargs):
        if isinstance(cfg_or_hidden, BertConfig):
            cfg = cfg_or_hidden
            super().__init__(cfg.hidden_size, cfg.num_heads,
                             dropout=cfg.dropout,
                             dtype=torch_dtype(cfg.dtype),
                             window=cfg.window)
        else:
            super().__init__(cfg_or_hidden, *args, **kwargs)

    def forward(self, x, attn_mask=None, mask=None):
        return super().forward(x, mask=mask if mask is not None
                               else attn_mask)


class BertLayer(HybridBlock):
    """Post-LN block: LN(x + attn(x)); LN(x + dropout(ffn(x)))."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = FusedSelfAttention(h, cfg.num_heads,
                                            dropout=cfg.dropout, dtype=dt,
                                            window=cfg.window)
        self.attn_norm = nn.LayerNorm(epsilon=eps, in_channels=h)
        self.ffn_intermediate = nn.Dense(cfg.intermediate_size, in_units=h,
                                         flatten=False, dtype=dt)
        self.ffn_output = nn.Dense(h, in_units=cfg.intermediate_size,
                                   flatten=False, dtype=dt)
        self.ffn_norm = nn.LayerNorm(epsilon=eps, in_channels=h)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x, attn_mask=None):
        x = self.attn_norm(x + self.attention(x, attn_mask))
        y = F.gelu(self.ffn_intermediate(x))
        y = self.dropout(self.ffn_output(y))
        return self.ffn_norm(x + y)


class BertModel(HybridBlock):
    """The encoder: embeddings, `num_layers` `BertLayer`s (a
    ``HybridSequential``) and the tanh pooler.  Built on its own its
    parameters wait for ``initialize()``, as in Gluon."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embed = nn.Embedding(cfg.vocab_size, h, dtype=dt)
        self.token_type_embed = nn.Embedding(cfg.type_vocab_size, h,
                                             dtype=dt)
        self.position_embed = nn.Embedding(cfg.max_position, h, dtype=dt)
        self.embed_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps,
                                       in_channels=h)
        self.embed_dropout = nn.Dropout(cfg.dropout)
        self.layers = nn.HybridSequential()
        for _ in range(cfg.num_layers):
            self.layers.add(BertLayer(cfg))
        self.pooler = nn.Dense(h, in_units=h, activation="tanh",
                               flatten=False, dtype=dt)

    def forward(self, input_ids, token_types=None, valid_length=None):
        b, l = input_ids.shape
        check_max_position(l, self.cfg.max_position)
        dev = self.word_embed.weight.data().device
        pos = torch.arange(l, device=dev)
        x = self.word_embed(input_ids) + self.position_embed(pos.reshape(1, l))
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_dropout(self.embed_norm(x))
        mask = None
        if valid_length is not None:
            vl = torch.as_tensor(valid_length, device=dev)
            mask = (pos.reshape(1, 1, l) < vl.reshape(b, 1, 1)).to(
                torch.float32).reshape(b, 1, 1, l)
        remat_on, policy = F.resolve_remat_policy(self.cfg.remat)
        for layer in self.layers:
            x = F.remat_call(layer, x, mask, policy=policy) if remat_on \
                else layer(x, mask)
        return x, self.pooler(x[:, 0])


class BertForPretraining(HybridBlock):
    """MLM + NSP heads (GluonNLP BERTForPretrain parity).

    With `masked_positions` ((batch, num_masked) indices) the MLM head runs
    on those slots only.  Construction initializes it, as
    `GPTForCausalLM`'s does: weights drawn on `device` (the card unless
    ``device="cpu"``) from `seed` -- N(0, 0.02) for matrices and
    embeddings, zero biases, unit LayerNorm gains, on the CPU generator so
    a seed gives the same weights on every device -- and one dropout
    generator on `device`, also seeded from `seed`, shared by every
    dropout (hidden and attention); ``initialize()`` after it is a no-op
    unless ``force_reinit=True``."""

    def __init__(self, cfg: BertConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        h = cfg.hidden_size
        self.bert = BertModel(cfg)
        self.mlm_dense = nn.Dense(h, in_units=h, flatten=False, dtype=dt)
        self.mlm_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps,
                                     in_channels=h)
        self.mlm_decoder = nn.Dense(cfg.vocab_size, in_units=h,
                                    flatten=False, dtype=dt)
        self.nsp_classifier = nn.Dense(2, in_units=h, dtype=dt)
        _seeded_fill(self, seed, dev)
        self.generator = torch.Generator(device=dev).manual_seed(int(seed))
        attach_generator(self, self.generator)

    @property
    def device(self) -> torch.device:
        return self.bert.word_embed.weight.data().device

    def reset_parameters(self, seed: int = 0) -> None:
        """Draw every weight again from `seed`, as the constructor does."""
        _seeded_fill(self, seed, self.device)

    def forward(self, input_ids, token_types=None, valid_length=None,
                masked_positions=None):
        seq, pooled = self.bert(input_ids, token_types, valid_length)
        if masked_positions is not None:
            # (b, l, h) -> (b, m, h) gather of the masked slots
            idx = torch.as_tensor(masked_positions, device=seq.device).long()
            seq = torch.gather(seq, 1, idx[..., None].expand(
                -1, -1, seq.shape[-1]))
        mlm = self.mlm_decoder(self.mlm_norm(F.gelu(self.mlm_dense(seq))))
        nsp = self.nsp_classifier(pooled)
        return mlm, nsp

    @staticmethod
    def flops_per_token(cfg: BertConfig, seq_len: int,
                        mask_frac: float = 1.0) -> float:
        """Training FLOPs/token (fwd+bwd ≈ 6·params + attention terms).
        `mask_frac` scales the MLM-head term when the head runs on masked
        positions only (`masked_positions`): 20/128 for phase-1 pretrain."""
        h, l, i = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
        per_layer = 4 * h * h + 2 * h * i  # qkv+proj + ffn (matmul mults)
        mlm = (cfg.vocab_size * h + h * h) * mask_frac
        params_matmul = l * per_layer + mlm
        # windowed attention touches min(L, 2w+1) keys per query, not L
        w = getattr(cfg, "window", None)
        kv_span = seq_len if w is None else min(seq_len, 2 * w + 1)
        attn = l * 2 * kv_span * h  # QK^T + PV per token
        return 6.0 * (params_matmul + attn)
