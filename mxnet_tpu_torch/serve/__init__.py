"""Inference serving (counterpart of ``mxnet_tpu/serve``): paged KV cache,
ragged paged-attention decode, continuous batching on one card.

A preallocated paged KV pool with a free-list page-table allocator
(`kv_cache`), ONE fused mixed prefill+decode step that updates the pool in
place (`engine`), and a continuous-batching scheduler with admission
backpressure, recompute-preemption eviction and per-token streaming
(`scheduler`).  The transformer decode math (`decode`) is shared with
`GPTForCausalLM.generate`, so serving and single-model generation cannot
diverge.
"""
from .decode import (  # noqa: F401
    extract_decode_weights, transformer_step, lm_logits,
)
from .kv_cache import KVPools, PageAllocator  # noqa: F401
from .scheduler import ContinuousBatchingScheduler, ServeRequest  # noqa: F401
from .engine import InferenceEngine, ServeConfig  # noqa: F401

__all__ = [
    "InferenceEngine", "ServeConfig", "ContinuousBatchingScheduler",
    "ServeRequest", "KVPools", "PageAllocator", "extract_decode_weights",
    "transformer_step", "lm_logits",
]
