"""Shared incremental-decode transformer core (counterpart of
``mxnet_tpu/serve/decode.py``).

ONE implementation of the cached pre-LN decoder step, used by both
surfaces that decode token by token:

- ``GPTForCausalLM.generate`` — dense per-request caches (`dense_kv_fn`);
- the serving engine — a shared paged KV pool with per-slot page tables
  and mixed prefill/decode chunks (`serve.kv_cache.make_paged_kv_fn`).

The transformer arithmetic (layernorms, fused-QKV projection, RoPE,
residuals, tanh-GELU FFN, LM head) is written once over a chunk of C
tokens; where the new K/V go and how attention reads the cached context
is injected as ``kv_fn(layer_idx, q, k_new, v_new) -> context``.

Weights travel as a plain dict of tensors (`extract_decode_weights`).  Any
matmul weight may be a `QuantizedTensor` (`quantize_decode_weights`); every
projection then routes through ``matmul_nt``, which launches the
dequant-matmul kernel on the card.  Embeddings, positions, norms and
biases stay dense.  Only ``tp=1`` is ported.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ops.attention import rope_rotate
from ..ops.paged_attention import _dense_attend
from ..ops.quantized_matmul import (gather_rows, matmul_nt,
                                    quantize_weight, weight_nbytes)

__all__ = ["extract_decode_weights", "transformer_step", "lm_logits",
           "layer_norm", "quantize_decode_weights", "decode_weight_bytes",
           "dense_kv_fn", "QUANT_DEFAULT_TARGETS"]


def extract_decode_weights(model) -> dict:
    """Plain-dict view of a ``GPTForCausalLM``'s decoder weights (tensors
    share storage with the block's Gluon parameters)."""
    t = model.transformer

    def w(p):
        return p.data().detach()

    layers = []
    for blk in t.layers:
        layers.append(dict(
            ln1_g=w(blk.attn_norm.gamma), ln1_b=w(blk.attn_norm.beta),
            wqkv=w(blk.attention.attn_qkv.weight),
            bqkv=w(blk.attention.attn_qkv.bias),
            wo=w(blk.attention.attn_proj.weight),
            bo=w(blk.attention.attn_proj.bias),
            ln2_g=w(blk.ffn_norm.gamma), ln2_b=w(blk.ffn_norm.beta),
            w1=w(blk.ffn.ffn_intermediate.weight),
            b1=w(blk.ffn.ffn_intermediate.bias),
            w2=w(blk.ffn.ffn_output.weight),
            b2=w(blk.ffn.ffn_output.bias)))
    cfg = model.cfg
    head = None if cfg.tie_embeddings else w(model.lm_head.weight)
    pos = None if cfg.rope else w(t.position_embed.weight)
    return dict(embed=w(t.word_embed.weight), pos=pos,
                lnf_g=w(t.final_norm.gamma), lnf_b=w(t.final_norm.beta),
                head=head, layers=layers)


# the matmul weights quantization targets by default: every FFN /
# attention projection plus the (untied) LM head.  Embeddings stay dense
# unless allowlisted ("embed"); norms/biases are never quantized.
QUANT_DEFAULT_TARGETS = ("wqkv", "wo", "w1", "w2", "head")


def quantize_decode_weights(P: dict, bits: int = 8, include=(),
                            thresholds: Optional[Dict[str, float]] = None):
    """Rewrite an `extract_decode_weights` dict to int8/int4 planes;
    ``include`` opts more leaves in (``"embed"``: the table is then
    dequantized per gathered row and the tied head runs K2).
    ``thresholds`` maps ``"layers.<i>.<name>"`` or top-level names (a
    `contrib.quantization.LayerCalibrator.thresholds()` dict) to
    calibrated activation amax values; each rides on its leaf as
    ``act_amax`` for the ``MXTPU_QUANT_ACT=1`` int8-activation path, the
    leaf's own name first, then its kind (``"wqkv"``).

    Returns ``(newP, info)``; info records bits, the dense and quantized
    bytes of the rewritten leaves, and the skipped names — the same dict
    the JAX package returns."""
    targets = set(QUANT_DEFAULT_TARGETS) | set(include)
    thresholds = thresholds or {}
    skipped, quantized = [], []
    dense_bytes = q_bytes = 0

    def one(name, key, w):
        nonlocal dense_bytes, q_bytes
        if w is None:
            return None
        if key not in targets or w.dim() != 2:
            skipped.append(name)
            return w
        qt = quantize_weight(w, bits, act_amax=thresholds.get(
            name, thresholds.get(key)))
        dense_bytes += weight_nbytes(w)
        q_bytes += qt.nbytes()
        quantized.append(name)
        return qt

    newP = dict(P)
    for key in ("embed", "pos", "head"):
        newP[key] = one(key, key, P.get(key))
    layers = []
    for li, L in enumerate(P["layers"]):
        NL = dict(L)
        for key in ("wqkv", "wo", "w1", "w2"):
            NL[key] = one(f"layers.{li}.{key}", key, L[key])
        layers.append(NL)
    newP["layers"] = layers
    info = {"bits": int(bits), "scheme": "symmetric-per-channel",
            "quantized": quantized, "skipped": sorted(set(skipped)),
            "f32_bytes": int(dense_bytes), "quantized_bytes": int(q_bytes),
            "saved_bytes": int(dense_bytes - q_bytes)}
    return newP, info


def decode_weight_bytes(P: dict) -> int:
    """Stored bytes of a decode-weight dict (dense or quantized)."""
    total = 0
    for key, v in P.items():
        if key == "layers":
            total += sum(weight_nbytes(x) for L in v for x in L.values())
        elif v is not None:
            total += weight_nbytes(v)
    return total


def layer_norm(x, g, b, eps):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * g + b


def transformer_step(P: dict, cfg, tok, pos,
                     kv_fn: Callable[[int, torch.Tensor, torch.Tensor,
                                      torch.Tensor], torch.Tensor],
                     tp: int = 1, matmul=matmul_nt):
    """Run C cached decoder tokens per batch row through the transformer.

    P: weights from `extract_decode_weights`; cfg: the model's
    ``GPTConfig``; tok: (B, C) int token ids; pos: (B, C) absolute
    positions; kv_fn(li, q, k_new, v_new) receives the layer index,
    rotated queries (B, H, C, D) and new keys/values (B, Hkv, C, D),
    must make the new K/V visible to its cache, and returns the attention
    context (B, H, C, D).  `matmul` is ``x @ w.T`` for every projection
    (`matmul_nt`; `matmul_nt_reference` runs the plain versions).

    Returns the final-layernormed hidden states (B, C, E).
    """
    if tp != 1:
        raise MXNetError(f"tp={tp}: tensor-parallel decode is not ported "
                         "to mxnet_tpu_torch yet (ROADMAP.md queue C)")
    H, E = cfg.num_heads, cfg.hidden_size
    D = E // H
    Hkv = cfg.num_kv_heads or H
    eps = cfg.layer_norm_eps
    B, C = tok.shape
    kvw = Hkv * D
    h = gather_rows(P["embed"], tok.long())               # (B, C, E)
    if not cfg.rope:
        h = h + P["pos"][pos.long()]
    for li, L in enumerate(P["layers"]):
        a = layer_norm(h, L["ln1_g"], L["ln1_b"], eps)
        qkv = matmul(a, L["wqkv"]) + L["bqkv"]
        q = qkv[..., :E].reshape(B, C, H, D).transpose(1, 2)
        k = qkv[..., E:E + kvw].reshape(B, C, Hkv, D).transpose(1, 2)
        v = qkv[..., E + kvw:].reshape(B, C, Hkv, D).transpose(1, 2)
        if cfg.rope:
            # cached keys are stored pre-rotated
            q = rope_rotate(q, pos[:, None, :], cfg.rope_theta)
            k = rope_rotate(k, pos[:, None, :], cfg.rope_theta)
        ctx = kv_fn(li, q, k, v)                           # (B, H, C, D)
        attn = matmul(ctx.transpose(1, 2).reshape(B, C, E), L["wo"])
        h = h + attn + L["bo"]
        f = layer_norm(h, L["ln2_g"], L["ln2_b"], eps)
        # jax.nn.gelu defaults to the tanh approximation; the exact erf
        # GELU would change greedy streams
        inter = F.gelu(matmul(f, L["w1"]) + L["b1"], approximate="tanh")
        h = h + matmul(inter, L["w2"]) + L["b2"]
    return layer_norm(h, P["lnf_g"], P["lnf_b"], eps)


def lm_logits(P: dict, h, tp: int = 1, matmul=matmul_nt):
    """LM-head logits for hidden states `h` (..., E) -> (..., V); the tied
    head reads the embedding table."""
    if tp != 1:
        raise MXNetError(f"tp={tp}: tensor-parallel decode is not ported "
                         "to mxnet_tpu_torch yet (ROADMAP.md queue C)")
    return matmul(h, P["embed"] if P["head"] is None else P["head"])


def dense_kv_fn(kcache, vcache, pos, window: Optional[int] = None):
    """A `kv_fn` over dense per-request caches — the `generate` path.

    kcache/vcache: (n_layers, B, Hkv, T, D), updated IN PLACE at the
    chunk's start position (chunk positions are contiguous and identical
    across rows in generate); pos: (B, C) absolute positions."""
    t0 = int(pos[0, 0])

    def kv_fn(li, q, k_new, v_new):
        C = k_new.shape[2]
        kcache[li, :, :, t0:t0 + C] = k_new
        vcache[li, :, :, t0:t0 + C] = v_new
        return _dense_attend(q, kcache[li], vcache[li], pos, window=window)

    return kv_fn
