"""GPT-style decoder-only causal language model (counterpart of
``mxnet_tpu/models/gpt.py``).

A pre-LN transformer with a fused-QKV projection, learned positions (or
RoPE), optional GQA and sliding window, and tied embeddings by default.
Every class is a Gluon `HybridBlock` built from `gluon.nn` layers (the
``layers`` stack a ``HybridSequential``), with the JAX package's parameter
names (``transformer.word_embed.weight``,
``transformer.layers.<i>.attention.attn_qkv.weight``, …,
``transformer.final_norm.gamma``, ``lm_head.weight``), so
`collect_params`, `load_parameters` and `convert.load_jax_params` carry
weights across name for name.

LayerNorm parameters stay f32 in a bf16 or f16 model, as Gluon keeps
them, and every norm takes ``layer_norm_eps``.

``forward`` gives the causal-LM logits over a whole sequence (the training
path): the embeddings, each pre-LN block — attention through the causal
flash kernels on the card, the second norm fused with the residual add
(`ops.nn.layer_norm_residual`) — under `ops.nn.remat_call` when the
``remat`` knob says so, the final norm and the (tied) head.  `generate`
decodes through the shared decode core (`serve.decode`) with dense
per-request caches, token by token, exactly as the JAX
``_generate_cached`` scan does; ``use_cache=False`` recomputes the full
context for each new token; ``num_beams > 1`` runs JAX's length-normalised
beam search over the same dense-cache core (`_generate_beam`).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import autograd as _ag
from ..base import MXNetError
from ..device import resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import accepts_ndarray
from ..ops import nn as F
from .layers import (FeedForward, FusedSelfAttention, _seeded_fill,
                     attach_generator, check_max_position)

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM",
           "gpt_small", "gpt_medium"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a config dtype name (``"float32"``,
    ``"bfloat16"``, ``"float16"``)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise MXNetError(f"unsupported model dtype {name!r}; use one of "
                         f"{sorted(_DTYPES)}") from None


class GPTConfig:
    def __init__(self, vocab_size=50257, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=1024,
                 dropout=0.1, layer_norm_eps=1e-5, tie_embeddings=True,
                 dtype="float32", remat=False, window=None, rope=False,
                 rope_theta=10000.0, num_kv_heads=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.tie_embeddings = tie_embeddings
        self.dtype = dtype
        # recompute each layer's activations in backward: False/True or a
        # named policy (`ops.nn.resolve_remat_policy`; MXTPU_REMAT_POLICY
        # overrides)
        self.remat = remat
        # Mistral-style sliding-window attention: each position attends
        # the last `window` tokens only
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        # rotary position embeddings instead of learned absolute positions
        if rope and (hidden_size // num_heads) % 2:
            raise ValueError(
                f"rope requires an even head_dim; hidden_size="
                f"{hidden_size} / num_heads={num_heads} gives "
                f"{hidden_size // num_heads}")
        self.rope = rope
        self.rope_theta = rope_theta
        # grouped-query attention: kv carry this many heads (< num_heads)
        if num_kv_heads is not None and num_heads % num_kv_heads:
            raise ValueError(f"num_heads ({num_heads}) must be divisible "
                             f"by num_kv_heads ({num_kv_heads})")
        self.num_kv_heads = num_kv_heads


def gpt_small(**kwargs):
    """GPT-2 small (HF ``gpt2``): vocab 50257, hidden 768, 12 layers, 12
    heads, FFN 3072, 1024 positions, tied embeddings."""
    return GPTConfig(**kwargs)


def gpt_medium(**kwargs):
    cfg = dict(hidden_size=1024, num_layers=24, num_heads=16,
               intermediate_size=4096)
    cfg.update(kwargs)
    return GPTConfig(**cfg)


class GPTBlock(HybridBlock):
    """Pre-LN block (GPT-2 style): x + attn(ln(x)); x + ffn(ln(x))."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attn_norm = nn.LayerNorm(epsilon=eps, in_channels=h)
        self.attention = FusedSelfAttention(
            h, cfg.num_heads, dropout=cfg.dropout, causal=True, dtype=dt,
            window=cfg.window,
            rope_theta=cfg.rope_theta if cfg.rope else None,
            num_kv_heads=cfg.num_kv_heads)
        self.ffn_norm = nn.LayerNorm(epsilon=eps, in_channels=h)
        self.ffn = FeedForward(h, cfg.intermediate_size,
                               dropout=cfg.dropout, dtype=dt)

    def forward(self, x):
        # the residual add fused into the second norm: s = x + attn_out
        # and ffn_norm(s) in one pass
        att = self.attention(self.attn_norm(x))
        ln = self.ffn_norm
        normed, s = ln._norm_residual(att, x, ln.gamma.data(),
                                      ln.beta.data(), eps=ln._epsilon)
        return s + self.ffn(normed)


class GPTModel(HybridBlock):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.word_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                       dtype=dt)
        if not cfg.rope:
            self.position_embed = nn.Embedding(cfg.max_position,
                                               cfg.hidden_size, dtype=dt)
        self.embed_dropout = nn.Dropout(cfg.dropout)
        self.layers = nn.HybridSequential()
        for _ in range(cfg.num_layers):
            self.layers.add(GPTBlock(cfg))
        self.final_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps,
                                       in_channels=cfg.hidden_size)

    def forward(self, input_ids):
        b, l = input_ids.shape
        check_max_position(l, self.cfg.max_position)
        x = self.word_embed(input_ids)
        if not self.cfg.rope:
            pos = torch.arange(l, device=x.device)
            x = x + self.position_embed(pos.reshape(1, l))
        x = self.embed_dropout(x)
        remat_on, policy = F.resolve_remat_policy(self.cfg.remat)
        for layer in self.layers:
            x = F.remat_call(layer, x, policy=policy) if remat_on \
                else layer(x)
        return self.final_norm(x)


def _rank_mask(logits, keep_n, order=None):
    """Keep exactly the first `keep_n` positions of the stable descending
    order (lower vocab index wins ties); the rest get -1e30.  Pass a
    precomputed descending `order` to reuse an existing sort."""
    if order is None:
        order = torch.argsort(-logits, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return torch.where(ranks < keep_n, logits, -1e30)


def _filter_logits(logits, top_k=0, top_p=1.0):
    """Top-k then top-p (nucleus) filtering over the last axis, applied
    in sequence like HF `TopKLogitsWarper` -> `TopPLogitsWarper`: the
    nucleus is computed over the renormalised post-top-k softmax.
    Dropped tokens get -1e30; exact under ties; the argmax always
    survives."""
    V = logits.shape[-1]
    if top_k and 0 < top_k < V:
        logits = _rank_mask(logits, top_k)
    if top_p < 1.0:
        order = torch.argsort(-logits, dim=-1, stable=True)
        sorted_logits = torch.gather(logits, -1, order)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # a sorted position is INSIDE the nucleus while the mass BEFORE
        # it is < p (the first token always stays)
        inside = (cum - probs) < top_p
        keep_n = torch.clamp(inside.sum(dim=-1, keepdim=True), min=1)
        logits = _rank_mask(logits, keep_n, order=order)
    return logits


class GPTForCausalLM(HybridBlock):
    """Next-token LM head; with `tie_embeddings` the decoder reuses the
    input embedding matrix (GPT-2 parity).

    Construction initializes it: the weights are drawn on `device` (the
    card unless ``device="cpu"``) from `seed` -- N(0, 0.02) for matrices
    and embeddings, zero biases, unit LayerNorm gains, on the CPU
    generator, so a seed gives the same weights on every device -- and
    one dropout generator on `device`, also seeded from `seed`, is shared
    by every dropout (embedding, hidden and attention).  So Gluon's
    ``initialize()`` after it is a no-op, as on any initialized block, and
    ``initialize(init, force_reinit=True)`` redraws every parameter as
    JAX's does (its own initializer, else `init`, else ``Uniform()``) from
    the port's generators (`random.seed`).  `collect_params`,
    `save_parameters` / `load_parameters` (the JAX ``.npz``), `cast`,
    `hybridize` and the hooks work as on any Gluon block."""

    def __init__(self, cfg: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.transformer = GPTModel(cfg)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Dense(cfg.vocab_size, in_units=cfg.hidden_size,
                                    use_bias=False, flatten=False,
                                    dtype=torch_dtype(cfg.dtype))
        _seeded_fill(self, seed, dev)
        self.generator = torch.Generator(device=dev).manual_seed(int(seed))
        attach_generator(self, self.generator)

    @property
    def device(self) -> torch.device:
        return self.transformer.word_embed.weight.data().device

    def reset_parameters(self, seed: int = 0) -> None:
        """Draw every weight again from `seed`, as the constructor does."""
        _seeded_fill(self, seed, self.device)

    def forward(self, input_ids):
        """Causal-LM logits (B, L, V) of token ids (B, L); the tied head
        multiplies in the promoted dtype of the hidden states and the
        table, as ``np.matmul`` does."""
        x = self.transformer(input_ids)
        if self.cfg.tie_embeddings:
            return F.fully_connected(
                x, self.transformer.word_embed.weight.data())
        return self.lm_head(x)

    @staticmethod
    def flops_per_token(cfg: GPTConfig, seq_len: int) -> float:
        """Training FLOPs a token, the JAX package's count: 6x the
        parameter matmuls (q/k/v/o, FFN, head) plus 12 * layers * hidden
        * the mean key span a query attends; causal attention counts the
        keys at or before the query, (L + 1) / 2 on average (a causal
        window clamps each span at w + 1)."""
        h, l, i = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
        kvh = cfg.num_kv_heads or cfg.num_heads
        kv_width = h * kvh // cfg.num_heads
        per_layer = 2 * h * h + 2 * h * kv_width + 2 * h * i
        head = cfg.vocab_size * h
        w = cfg.window
        if w is None:
            avg_span = (seq_len + 1) / 2
        else:
            ww = min(w, seq_len - 1)
            avg_span = (ww * (ww + 1) / 2
                        + (seq_len - ww) * (ww + 1)) / seq_len
        return 6 * (l * per_layer + head) + 12 * l * h * avg_span

    @accepts_ndarray
    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens=20, temperature=1.0,
                 greedy=True, use_cache=True, num_beams=1,
                 eos_token_id=None, top_k=0, top_p=1.0,
                 generator: Optional[torch.Generator] = None):
        """Autoregressive decode: prompt (B, L) -> (B, L + max_new_tokens)
        int32 token ids on the model's device (an ``mx.np`` array in, an
        array out); the parameters are JAX's, in JAX's order, and
        `generator` last.

        Runs the dense-cache decode core one position at a time, prompt
        included, exactly as the JAX ``_generate_cached`` scan does (so a
        greedy stream equals the serving engine's).  ``use_cache=False``
        recomputes the full context through `forward` (dropout off) for
        each new token, as JAX's simple path does.  Sampling
        (``greedy=False``) draws from `generator` (default: a fresh
        seeded generator on the model's device) after `temperature`,
        `top_k` and `top_p` filtering.

        ``num_beams > 1``: length-normalised beam search on the same
        cached core (`_generate_beam`; finished beams freeze on
        `eos_token_id`); returns the best beam per batch row.  Beam search
        is deterministic — combining it with the sampling knobs raises
        ValueError, as in JAX."""
        if num_beams > 1:
            if not greedy or top_k or top_p < 1.0 or temperature != 1.0:
                raise ValueError(
                    "num_beams > 1 runs deterministic beam search; the "
                    "sampling knobs (greedy=False, temperature, top_k, "
                    "top_p) are not supported with it")
            return self._generate_beam(input_ids, max_new_tokens,
                                       num_beams, eos_token_id)
        cfg = self.cfg
        dev = self.device
        prompt = torch.as_tensor(input_ids, device=dev).to(torch.int32)
        if prompt.dim() == 1:
            prompt = prompt[None]
        if not greedy and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def pick(logits):
            if greedy:
                return torch.argmax(logits, dim=-1)
            filtered = _filter_logits(logits.float() / temperature, top_k,
                                      top_p)
            return torch.multinomial(torch.softmax(filtered, dim=-1), 1,
                                     generator=generator)[:, 0]

        if not use_cache:
            ids = prompt
            with _ag.predict_mode():
                for _ in range(max_new_tokens):
                    nxt = pick(self(ids)[:, -1]).to(torch.int32)
                    ids = torch.cat([ids, nxt[:, None]], dim=1)
            return ids
        from ..serve.decode import (dense_kv_fn, extract_decode_weights,
                                    lm_logits, transformer_step)
        B, plen = prompt.shape
        T = plen + max_new_tokens
        check_max_position(T, cfg.max_position)
        P = extract_decode_weights(self)
        H = cfg.num_heads
        Hkv = cfg.num_kv_heads or H
        D = cfg.hidden_size // H
        kc = torch.zeros((cfg.num_layers, B, Hkv, T, D),
                         dtype=P["embed"].dtype, device=dev)
        vc = torch.zeros_like(kc)
        out = torch.empty((B, T), dtype=torch.int32, device=dev)
        out[:, :plen] = prompt
        for t in range(T - 1):
            pos = torch.full((B, 1), t, dtype=torch.int32, device=dev)
            kv_fn = dense_kv_fn(kc, vc, pos, window=cfg.window)
            h = transformer_step(P, cfg, out[:, t:t + 1], pos, kv_fn)
            if t + 1 < plen:
                continue            # prefill: the prompt token is forced
            out[:, t + 1] = pick(lm_logits(P, h[:, 0])).to(torch.int32)
        return out

    @torch.inference_mode()
    def _generate_beam(self, input_ids, max_new_tokens, num_beams,
                       eos_token_id, length_penalty=1.0):
        """Batched beam search on the dense-cache decode core, as JAX's
        ``_generate_beam`` does it.

        Prefill runs at batch B (beams are identical until they diverge),
        then the caches tile to B*K and each step takes the top K over
        (beams x vocab) — ties to the lower index, as ``lax.top_k`` —
        regathering caches and token histories by source beam.  A
        finished beam (it emitted `eos_token_id`) contributes one 0-logp
        continuation, so its score freezes; the winner maximises score /
        length**length_penalty."""
        from ..serve.decode import (dense_kv_fn, extract_decode_weights,
                                    lm_logits, transformer_step)
        cfg = self.cfg
        dev = self.device
        prompt = torch.as_tensor(input_ids, device=dev).to(torch.int32)
        if prompt.dim() == 1:
            prompt = prompt[None]
        K = int(num_beams)
        B, plen = prompt.shape
        T = plen + max_new_tokens
        check_max_position(T, cfg.max_position)
        P = extract_decode_weights(self)
        H = cfg.num_heads
        Hkv = cfg.num_kv_heads or H
        D = cfg.hidden_size // H
        eos = -1 if eos_token_id is None else int(eos_token_id)
        NEG = -1e9

        def token_step(tok, t, kc, vc):
            pos = torch.full((tok.shape[0], 1), t, dtype=torch.int32,
                             device=dev)
            kv_fn = dense_kv_fn(kc, vc, pos, window=cfg.window)
            h = transformer_step(P, cfg, tok[:, None], pos, kv_fn)
            return lm_logits(P, h[:, 0])

        # phase 1: prefill at batch B — the beams are identical here
        kc = torch.zeros((cfg.num_layers, B, Hkv, T, D),
                         dtype=P["embed"].dtype, device=dev)
        vc = torch.zeros_like(kc)
        for t in range(plen - 1):
            token_step(prompt[:, t], t, kc, vc)
        kc = kc.repeat_interleave(K, dim=1)
        vc = vc.repeat_interleave(K, dim=1)
        scores = torch.full((B, K), NEG, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        hist = torch.zeros((B, K, T), dtype=torch.int32, device=dev)
        hist[:, :, :plen] = prompt[:, None]
        prev = prompt[:, plen - 1].repeat_interleave(K)
        finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
        fin_len = torch.zeros((B, K), dtype=torch.int32, device=dev)
        base = torch.arange(B, device=dev)[:, None] * K
        for t in range(plen - 1, T - 1):
            logits = token_step(prev, t, kc, vc)
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, -1)
            V = logp.shape[-1]
            frozen = torch.full((V,), NEG, dtype=torch.float32, device=dev)
            frozen[max(eos, 0)] = 0.0
            cand = scores[:, :, None] + torch.where(
                finished[:, :, None], frozen, logp)
            order = torch.sort(cand.reshape(B, K * V), dim=1,
                               descending=True, stable=True)
            top, idx = order.values[:, :K], order.indices[:, :K]
            src = idx // V
            tok = (idx % V).to(torch.int32)
            was_fin = torch.gather(finished, 1, src)
            fin_len = torch.gather(fin_len, 1, src)
            now_fin = was_fin | (tok == eos)
            gen_len = t + 2 - plen        # tokens generated incl. this one
            fin_len = torch.where(now_fin & ~was_fin, gen_len, fin_len)
            rows = (base + src).reshape(B * K)
            kc, vc = kc[:, rows], vc[:, rows]
            hist = torch.gather(hist, 1, src[:, :, None].expand(-1, -1, T))
            hist[:, :, t + 1] = tok
            prev, scores, finished = tok.reshape(B * K), top, now_fin
        lengths = torch.where(finished, fin_len, max_new_tokens).float()
        norm = scores / torch.clamp(lengths, min=1.0) ** float(length_penalty)
        best = torch.argmax(norm, dim=1)
        return hist[torch.arange(B, device=dev), best]
