"""Inference serving engine: one fused step over a paged KV pool
(counterpart of ``mxnet_tpu/serve/engine.py``).

Wraps a ``GPTForCausalLM``: each serving iteration — embed a ragged chunk
of tokens for every slot, write the new K/V into the paged pool, ragged
paged attention, LM head, sample — is ONE fused step over all slots.  On
the card the step runs the hand-written kernels (K1 ragged paged
attention, and K2 dequant-matmul under ``quant_bits``); the dense
projections stay ``torch.matmul``.  The step runs under
``torch.inference_mode()`` and updates the KV pool in place, which is what
buffer donation buys the JAX engine.

Typical use::

    eng = InferenceEngine(model, ServeConfig(max_slots=8))
    eng.warmup()
    h = eng.submit([1, 2, 3], max_new_tokens=16,
                   on_token=lambda t, r: print(t))
    eng.run_until_idle()
    full = h.result()

or one-shot: ``eng.generate([1, 2, 3], max_new_tokens=16)``.

The decode fast path: ``spec_tokens=k`` lets a drafter (`serve.spec`,
default `NGramDrafter`) propose k tokens a greedy slot, verified by one
fused step at width k+1 whose per-position argmax the scheduler accepts
as a run; ``prefix_cache=True`` keeps finished prompts' KV pages in a
`PrefixIndex`, attached by reference to later requests with the same
prefix and forked (`copy_page`) before a write.

Quantized serving: ``kv_dtype="int8"`` keeps the KV pool in int8 with one
f32 scale a stored vector (3.76x fewer bytes than f32 at GPT-2 small's
D 64), read by K1's int8 variant; ``quant_bits`` 8/4 stores the
projections as int8/int4 planes for K2; ``MXTPU_QUANT_ACT=1`` rounds the
activations of those projections to int8 too (`int8_act_matmul`, no K2),
at the thresholds of ``act_thresholds`` (a
`contrib.quantization.LayerCalibrator.thresholds()` dict) where given.

Features still raising `MXNetError` until their slice (ROADMAP.md queue
A): ``tp > 1`` and ``role != "both"`` (A12, A15), export and
`adopt_executables` (A16).  The serving side of QoS, tracing and
telemetry (A14 part 2, A15) is not ported; the `telemetry`, `tracing` and
`health` modules themselves are (A14 part 1, on the training path).
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..base import MXNetError, getenv_int
from ..device import resolve_device
from ..models.gpt import _filter_logits, torch_dtype
from ..ops.paged_attention import (paged_attention_reference,
                                   ragged_paged_attention,
                                   recommended_page_size)
from ..ops.quantized_matmul import matmul_nt, matmul_nt_reference
from .decode import (decode_weight_bytes, extract_decode_weights,
                     lm_logits, quantize_decode_weights, transformer_step)
from .kv_cache import KVPools, PageAllocator, PrefixIndex, make_paged_kv_fn
from .scheduler import ContinuousBatchingScheduler, ServeRequest
from .spec import Drafter, NGramDrafter

__all__ = ["ServeConfig", "InferenceEngine"]


def _not_ported(what: str) -> MXNetError:
    return MXNetError(
        f"{what} is not ported to mxnet_tpu_torch yet (see ROADMAP.md "
        "queue C)")


def _default_page_size() -> int:
    """MXTPU_SERVE_PAGE_SIZE wins; otherwise the paged-attention
    autotuner's kept recommendation for this device, else 16 (the JAX
    package's order)."""
    return getenv_int("MXTPU_SERVE_PAGE_SIZE", 0) or recommended_page_size(16)


@dataclass
class ServeConfig:
    """Serving knobs; every field defaults from its ``MXTPU_SERVE_*``
    environment variable, as in the JAX package."""

    max_slots: int = field(
        default_factory=lambda: getenv_int("MXTPU_SERVE_SLOTS", 8))
    page_size: int = field(default_factory=_default_page_size)
    num_pages: int = field(
        default_factory=lambda: getenv_int("MXTPU_SERVE_PAGES", 0))
    prefill_chunk: int = field(
        default_factory=lambda: getenv_int("MXTPU_SERVE_PREFILL_CHUNK", 16))
    max_len: int = field(
        default_factory=lambda: getenv_int("MXTPU_SERVE_MAX_LEN", 0))
    kv_dtype: str = field(
        default_factory=lambda: os.environ.get("MXTPU_SERVE_KV_DTYPE", ""))
    # per-request wall-clock deadline in ms (0 = none)
    deadline_ms: int = field(
        default_factory=lambda: getenv_int("MXTPU_SERVE_DEADLINE_MS", 0))
    # weight-only quantization: 8 or 4 rewrites the decode weights to
    # int8/int4 planes and routes the projections through K2
    quant_bits: int = field(
        default_factory=lambda: getenv_int("MXTPU_QUANT_BITS", 0))
    spec_tokens: int = field(
        default_factory=lambda: getenv_int("MXTPU_SPEC_TOKENS", 0))
    prefix_cache: bool = field(
        default_factory=lambda: getenv_int("MXTPU_PREFIX_CACHE", 0) > 0)
    tp: int = field(
        default_factory=lambda: getenv_int("MXTPU_SERVE_TP", 1))
    role: str = field(
        default_factory=lambda: os.environ.get(
            "MXTPU_SERVE_ROLE", "") or "both")
    # engine-wide sampling filter
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.max_slots < 1:
            raise MXNetError("max_slots must be >= 1")
        if self.page_size < 1:
            raise MXNetError("page_size must be >= 1")
        if self.prefill_chunk < 1:
            raise MXNetError("prefill_chunk must be >= 1")
        if self.tp < 1:
            raise MXNetError(
                f"tp must be >= 1, got {self.tp} (MXTPU_SERVE_TP)")
        if self.role not in ("prefill", "decode", "both"):
            raise MXNetError(
                f"role must be 'prefill', 'decode', or 'both'; got "
                f"{self.role!r} (MXTPU_SERVE_ROLE)")
        if self.quant_bits not in (0, 4, 8):
            raise MXNetError(
                f"quant_bits must be 0 (dense), 8, or 4; got "
                f"{self.quant_bits} (MXTPU_QUANT_BITS)")
        if self.spec_tokens < 0:
            raise MXNetError(
                f"spec_tokens must be >= 0, got {self.spec_tokens} "
                f"(MXTPU_SPEC_TOKENS)")


class InferenceEngine:
    """Continuous-batching inference over a ``GPTForCausalLM``.

    Runs on `device` (the card unless ``device="cpu"``).  ``seed`` seeds
    the sampling generator.  ``act_thresholds`` (with ``quant_bits``)
    attaches calibrated activation thresholds to the quantized weights
    (`quantize_weights`).  ``plain_ops=True`` builds the oracle engine:
    every step calls the plain versions (`paged_attention_reference`,
    `matmul_nt_reference`) by name, on any device — what `chip_smoke.py`
    holds the kernel engine against.

    ``drafter``: the token-proposal hook used when
    ``ServeConfig.spec_tokens`` > 0; defaults to the model-free
    :class:`~mxnet_tpu_torch.serve.spec.NGramDrafter` over each request's
    own context."""

    def __init__(self, model, config: Optional[ServeConfig] = None,
                 device=None, seed: int = 0, act_thresholds=None,
                 plain_ops: bool = False,
                 drafter: Optional[Drafter] = None):
        self.model = model
        self.cfg = model.cfg
        self.serve_config = config or ServeConfig()
        sc = self.serve_config
        self.device = resolve_device(device)
        if sc.tp > 1:
            raise _not_ported(f"tensor-parallel serving (tp={sc.tp})")
        if sc.role != "both":
            raise _not_ported(f"disaggregated serving (role={sc.role!r})")

        cfg = self.cfg
        H = cfg.num_heads
        self.n_kv_heads = cfg.num_kv_heads or H
        self.head_dim = cfg.hidden_size // H
        self.max_len = sc.max_len or cfg.max_position
        if self.max_len > cfg.max_position:
            raise MXNetError(
                f"MXTPU_SERVE_MAX_LEN={self.max_len} exceeds the model's "
                f"max_position={cfg.max_position}")
        self.max_pages_per_seq = max(
            1, math.ceil(self.max_len / sc.page_size))
        kv_dtype = sc.kv_dtype or cfg.dtype
        self.quantized = str(kv_dtype) == "int8"
        self._kv_dtype = torch.int8 if self.quantized else \
            torch_dtype(kv_dtype)
        self.tp = 1
        self.role = "both"
        self.plain_ops = bool(plain_ops)
        self._attend = (paged_attention_reference if plain_ops
                        else ragged_paged_attention)
        self._matmul = matmul_nt_reference if plain_ops else matmul_nt

        self.P = {k: _to(v, self.device)
                  for k, v in extract_decode_weights(model).items()}
        self.quant_bits = 0
        self.quant_info = None
        if sc.quant_bits:
            self.quantize_weights(sc.quant_bits, thresholds=act_thresholds)
        # auto pool size: every slot can hold a full-length sequence, plus
        # the reserved null page — PLUS the pages the quantized weights
        # just paid for.  An explicit num_pages wins.
        bonus = 0
        if sc.num_pages == 0 and self.quant_info is not None:
            bonus = self.quant_info["saved_bytes"] // max(
                1, self._page_nbytes())
        num_pages = sc.num_pages or \
            sc.max_slots * self.max_pages_per_seq + 1 + bonus
        self.bonus_pages = bonus
        self.pools = KVPools(cfg.num_layers, num_pages, sc.page_size,
                             self.n_kv_heads, self.head_dim, self._kv_dtype,
                             self.device)
        self.allocator = PageAllocator(num_pages, sc.page_size)
        #: cross-request prompt-prefix cache (MXTPU_PREFIX_CACHE): shared
        #: read-only page runs with COW forks; None when off
        self.prefix_index = (PrefixIndex(self.allocator, sc.page_size)
                             if sc.prefix_cache else None)
        #: speculative-decoding proposal hook (MXTPU_SPEC_TOKENS)
        self.drafter = drafter if drafter is not None else (
            NGramDrafter() if sc.spec_tokens > 0 else None)
        self.scheduler = ContinuousBatchingScheduler(self)
        dev = self.device if self.device.type == "cuda" else "cpu"
        self._gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.compile_seconds = None
        self._steps_executed = 0

    # ------------------------------------------------------------------
    # weight-only quantization
    # ------------------------------------------------------------------
    def _page_nbytes(self) -> int:
        """Device bytes of ONE physical KV page across all layers (K + V,
        plus the scale planes of an int8 pool: D + 4 bytes a vector)."""
        itemsize = torch.empty((), dtype=self._kv_dtype).element_size()
        per_vec = self.head_dim * itemsize + (4 if self.quantized else 0)
        return 2 * self.cfg.num_layers * self.serve_config.page_size \
            * self.n_kv_heads * per_vec

    def quantize_weights(self, bits: int, include=(),
                         thresholds=None) -> dict:
        """Rewrite the decode weights to int8/int4 planes (per-channel
        symmetric; `serve.decode.quantize_decode_weights`, with
        ``include`` and the calibrated activation ``thresholds``).  Called
        at construction for ``ServeConfig.quant_bits``; needs an idle
        engine.  Returns the quantization info dict."""
        if self.quant_bits:
            raise MXNetError(
                f"engine weights are already int{self.quant_bits}-"
                "quantized; re-quantizing quantized planes would "
                "compound the rounding — build a fresh engine")
        sched = getattr(self, "scheduler", None)
        if sched is not None and (sched.active_count or sched.queue_depth):
            raise MXNetError(
                "quantize_weights needs an idle engine (in-flight "
                "streams hold dense-weight KV state); drain() first")
        self.P, info = quantize_decode_weights(self.P, bits,
                                               include=include,
                                               thresholds=thresholds)
        self.quant_bits = int(bits)
        self.quant_info = info
        if getattr(self, "prefix_index", None) is not None:
            # cached prompt KV was computed with the dense weights
            self.prefix_index.clear()
        return info

    def weight_bytes(self) -> int:
        """Stored bytes of the decode weights (planes + scales when
        quantized)."""
        return decode_weight_bytes(self.P)

    # ------------------------------------------------------------------
    # the fused step
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _step(self, tok, num_tokens, start_pos, tables, ctx_lens, temps,
              greedy_mask, C: int, sample: bool):
        cfg = self.cfg
        dev = self.device
        tok, num_tokens, start_pos, tables, ctx_lens = (
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (tok, num_tokens, start_pos, tables, ctx_lens))
        kv_fn = make_paged_kv_fn(self.pools, tables, start_pos, num_tokens,
                                 ctx_lens, window=cfg.window,
                                 attend=self._attend)
        # padded rows may run past the table; clamp for the embedding
        # gather only (writes are masked, attention rows are ignored)
        pos = torch.clamp(
            start_pos[:, None] + torch.arange(C, device=dev,
                                              dtype=torch.int32)[None, :],
            max=cfg.max_position - 1)
        h = transformer_step(self.P, cfg, tok, pos, kv_fn,
                             matmul=self._matmul)
        B = tok.shape[0]
        rows = torch.arange(B, device=dev)
        last = h[rows, torch.clamp(num_tokens.long() - 1, min=0)]
        logits = lm_logits(self.P, last, matmul=self._matmul)   # (B, V)
        nxt = torch.argmax(logits, dim=-1)
        spec_k = self.serve_config.spec_tokens
        all_tok = None
        if spec_k > 0:
            # speculative verification: the greedy argmax at the TAIL fed
            # positions (B, T), T = min(C, k+1); column t is fed position
            # num_tokens - T + t (t = T-1 is the `last` row).  Tail
            # position t's argmax is the greedy continuation of the fed
            # prefix before it (causal attention), so the scheduler can
            # accept a run of matching drafts.  Each row goes through the
            # SAME (B, E) 2-D head product as `last`: a 3-D (B, C, E)
            # product could tile differently and flip a near-tie argmax.
            T = min(C, spec_k + 1)
            all_tok = torch.stack(
                [torch.argmax(lm_logits(
                    self.P, h[rows, torch.clamp(
                        num_tokens.long() - T + j, min=0)],
                    matmul=self._matmul), dim=-1)
                 for j in range(T)], dim=1).to(torch.int32).cpu().numpy()
        if sample:
            temps_t = torch.from_numpy(temps).to(dev)
            filtered = _filter_logits(
                logits.float() / temps_t[:, None],
                self.serve_config.top_k, self.serve_config.top_p)
            sampled = torch.multinomial(torch.softmax(filtered, dim=-1), 1,
                                        generator=self._gen)[:, 0]
            nxt = torch.where(torch.from_numpy(greedy_mask).to(dev), nxt,
                              sampled)
        return nxt.to(torch.int32).cpu().numpy(), all_tok

    def _execute(self, tok, num_tokens, start_pos, tables, ctx_lens, temps,
                 greedy_mask, C: int):
        """Run one fused step (called by the scheduler); returns
        ``(next_token[B], all_tok)`` as host arrays — `all_tok` is the
        (B, min(C, k+1)) verification argmax when speculation is on, else
        None.  The sampler draws only when some active slot samples, so
        greedy traffic leaves the generator untouched."""
        self._steps_executed += 1
        sample = bool((~greedy_mask & (num_tokens > 0)).any())
        return self._step(tok, num_tokens, start_pos, tables, ctx_lens,
                          temps, greedy_mask, C, sample)

    def copy_page(self, src: int, dst: int) -> None:
        """Copy ONE physical page (every layer, K and V, and the scale
        planes of an int8 pool) — the data half of a copy-on-write fork,
        after `PageAllocator.fork` moved a reference onto the fresh page.
        In place, on the step's stream, so the next step's writes and K1's
        reads are ordered after it."""
        for pool in self.pools.planes():
            pool[:, dst].copy_(pool[:, src])

    def _step_widths(self):
        """Chunk widths the engine steps at: the prefill chunk, the
        pure-decode C=1 step, and (speculation on) the k+1-wide
        verification row."""
        ws = {self.serve_config.prefill_chunk, 1}
        if self.serve_config.spec_tokens > 0:
            ws.add(self.serve_config.spec_tokens + 1)
        return sorted(ws)

    def warmup(self) -> float:
        """Build the kernels and run every chunk width (`_step_widths`)
        once over empty slots: every write goes to the null page and the
        pool's live pages are untouched.  Returns the seconds it took."""
        t0 = time.perf_counter()
        B = self.serve_config.max_slots
        z = np.zeros(B, np.int32)
        for C in self._step_widths():
            self._step(np.zeros((B, C), np.int32), z, z,
                       np.zeros((B, self.max_pages_per_seq), np.int32), z,
                       np.ones(B, np.float32), np.ones(B, bool), C, False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.compile_seconds = time.perf_counter() - t0
        return self.compile_seconds

    # ------------------------------------------------------------------
    # public API (delegates to the scheduler)
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 20, greedy: bool = True,
               temperature: float = 1.0, eos_token_id=None,
               on_token=None, deadline_ms=None) -> ServeRequest:
        return self.scheduler.submit(prompt, max_new_tokens,
                                     greedy=greedy, temperature=temperature,
                                     eos_token_id=eos_token_id,
                                     on_token=on_token,
                                     deadline_ms=deadline_ms)

    def step(self) -> bool:
        return self.scheduler.step()

    def run_until_idle(self, max_steps: int = 100000) -> int:
        return self.scheduler.run_until_idle(max_steps)

    def drain(self, max_steps: int = 100000):
        """Stop admitting new work, run every already-accepted stream to
        completion, and return the requests that were still QUEUED."""
        sched = self.scheduler
        sched.draining = True
        handed_back = sched.detach_queued()
        steps = 0
        while (sched.active_count or sched.queue_depth) \
                and steps < max_steps:
            sched.step()
            steps += 1
        return handed_back

    def generate(self, prompt, max_new_tokens: int = 20, greedy: bool = True,
                 temperature: float = 1.0, eos_token_id=None):
        """One-shot convenience: submit a single request, drive the loop
        to completion, return prompt + generated token ids (list)."""
        h = self.submit(prompt, max_new_tokens, greedy=greedy,
                        temperature=temperature, eos_token_id=eos_token_id)
        self.run_until_idle()
        return h.result(timeout=0)

    def export(self, path: str, passes=None):
        raise _not_ported("serve export")

    def load_export(self, path: str):
        raise _not_ported("serve export loading")

    def adopt_executables(self, other: "InferenceEngine"):
        raise _not_ported("adopt_executables")

    def stats(self) -> dict:
        return {
            "steps_executed": self._steps_executed,
            "queue_depth": self.scheduler.queue_depth,
            "active_slots": self.scheduler.active_count,
            "free_pages": self.allocator.free_pages,
            "page_occupancy": round(self.allocator.occupancy(), 4),
            "pool_bytes": self.pools.nbytes(),
            "weight_bytes": self.weight_bytes(),
            "quant_bits": self.quant_bits,
            "kv_dtype": "int8" if self.quantized else str(
                self._kv_dtype).replace("torch.", ""),
            "bonus_pages": self.bonus_pages,
            "compile_seconds": self.compile_seconds,
            "tp": self.tp,
            "role": self.role,
            "device": str(self.device),
            "plain_ops": self.plain_ops,
            "spec_tokens": self.serve_config.spec_tokens,
            "spec": self.scheduler.spec_stats(),
            "prefix_cache": (None if self.prefix_index is None
                             else self.prefix_index.stats()),
        }


def _to(v, device):
    """Move a decode-weight leaf (tensor, None, or the per-layer list of
    dicts) to `device`."""
    if v is None:
        return None
    if isinstance(v, list):
        return [{k: x.to(device) for k, x in L.items()} for L in v]
    return v.to(device)
