"""Ragged paged attention for the serving stack: CUDA kernel + plain torch.

Counterpart of ``mxnet_tpu/ops/pallas/paged_attention.py``.  ONE launch
handles a mixed continuous-batching step — some slots mid-prefill (a chunk
of C query tokens), others decoding (one query token) — attending over a
**paged KV pool** ``(num_pages, page_size, Hkv, D)``; each slot's logical
context is the concatenation of the pages its page table names.

- On a CUDA tensor, `ragged_paged_attention` launches the hand-written
  kernel ``csrc/paged_attention.cu`` (K1).  It walks only the keys below a
  slot's context length, folds the GQA query heads onto rows so K/V stream
  once per kv head, and keeps an f32 online softmax per row.  It raises
  on what the kernel does not take; it never falls back.
- On a CPU tensor it runs `paged_attention_reference`: gather the page
  table into a contiguous context and run `_dense_attend` — the plain
  version the CPU tests hold against the JAX package and `chip_smoke.py`
  holds the kernel against on the card.  `_dense_attend` is also what the
  dense-cache `GPTForCausalLM.generate` uses.

Masking is exact: hard-masked scores become ``MASK_VALUE`` whose exp
underflows to exactly 0.0, so a longer padded context contributes exact
zero terms and stays bit-identical to the unpadded computation.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from .. import kernels as _kernels

MASK_VALUE = -1e30

__all__ = ["ragged_paged_attention", "paged_attention_reference",
           "gather_pages", "MASK_VALUE"]


# ---------------------------------------------------------------------------
# dense attention over a contiguous cached context (shared semantics)
# ---------------------------------------------------------------------------

def _dense_attend(q, kc, vc, q_pos, ctx_len=None, window=None, scale=None):
    """Masked attention of chunk queries against a contiguous KV context.

    q: (B, H, C, D); kc/vc: (B, Hkv, T, D) (Hkv divides H — GQA); q_pos:
    (B, C) absolute position of each query row; ctx_len: (B,) valid
    context length (None = the causal mask alone suffices, the dense-cache
    decode case where unwritten slots are masked by q_pos).

    Scores in the activation dtype scaled by 1/sqrt(D) (the scale itself
    cast to that dtype), softmax in f32 and cast back, GQA scored per
    kv-head group without expanding the cache — the JAX function's dtype
    flow, step for step.
    """
    B, H, C, D = q.shape
    Hkv, T = kc.shape[1], kc.shape[2]
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(
            float(D), dtype=torch.float32, device=q.device)).to(q.dtype)
    rep = H // Hkv
    qg = q.reshape(B, Hkv, rep * C, D)
    s = (qg @ kc.transpose(-1, -2)).reshape(B, H, C, T) * scale
    t_idx = torch.arange(T, device=q.device)[None, None, None, :]
    pos = q_pos[:, None, :, None]
    mask = t_idx <= pos
    if ctx_len is not None:
        mask &= t_idx < ctx_len[:, None, None, None]
    if window is not None:
        mask &= t_idx >= pos - window
    s = torch.where(mask, s, MASK_VALUE)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    ctx = p.reshape(B, Hkv, rep * C, T) @ vc
    return ctx.reshape(B, H, C, D)


# ---------------------------------------------------------------------------
# page gathering + the plain version of K1
# ---------------------------------------------------------------------------

def gather_pages(pool, page_tables):
    """Materialise each slot's logical context from the paged pool.

    pool: (num_pages, page_size, Hkv, D); page_tables: (B, max_pages)
    int32 (unallocated entries may point anywhere — callers mask by
    ctx_len).  Returns (B, max_pages * page_size, Hkv, D)."""
    g = pool[page_tables.long()]                  # (B, maxp, ps, Hkv, D)
    B, maxp, ps, Hkv, D = g.shape
    return g.reshape(B, maxp * ps, Hkv, D)


def paged_attention_reference(q, kpool, vpool, page_tables, ctx_lens,
                              start_pos, window=None, scale=None,
                              out_dtype=None):
    """Plain version of K1: gather the page table to a contiguous context
    and run `_dense_attend`.  The CPU path and the kernel's oracle."""
    B, H, C, D = q.shape
    q_pos = start_pos[:, None] + torch.arange(C, device=q.device)[None, :]
    dt = out_dtype or q.dtype
    # (B, L, Hkv, D) -> (B, Hkv, L, D)
    kc = gather_pages(kpool, page_tables).to(dt).permute(0, 2, 1, 3)
    vc = gather_pages(vpool, page_tables).to(dt).permute(0, 2, 1, 3)
    return _dense_attend(q.to(dt), kc, vc, q_pos, ctx_len=ctx_lens,
                         window=window, scale=scale)


# ---------------------------------------------------------------------------
# K1: the CUDA kernel (csrc/paged_attention.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        f = _kernels.load("paged_attention").mxt_ragged_paged_attention
        f.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _I, ctypes.c_float, _I, _P]
        f.restype = _I
        _fn = f
    return _fn


def _rpa_cuda(q, kpool, vpool, page_tables, ctx_lens, start_pos, window,
              scale):
    """Check the operands, then launch K1 on the current stream."""
    B, H, C, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise MXNetError(f"ragged_paged_attention kernel takes float32 or "
                         f"bfloat16 queries, got {q.dtype}")
    if kpool.dtype != q.dtype or vpool.dtype != q.dtype:
        raise MXNetError(
            f"ragged_paged_attention kernel needs pools in the query dtype "
            f"({q.dtype}); got {kpool.dtype}/{vpool.dtype}")
    if kpool.dim() != 4 or kpool.shape != vpool.shape or \
            kpool.shape[3] != D:
        raise MXNetError(
            f"pools must both be (num_pages, page_size, Hkv, {D}); got "
            f"{tuple(kpool.shape)} and {tuple(vpool.shape)}")
    if D > 256:
        raise MXNetError(f"ragged_paged_attention kernel takes head_dim "
                         f"<= 256, got {D}")
    if page_tables.dim() != 2 or page_tables.shape[0] != B or \
            tuple(ctx_lens.shape) != (B,) or tuple(start_pos.shape) != (B,):
        raise MXNetError(
            f"page_tables (B, max_pages) and ctx_lens/start_pos (B,) must "
            f"match B={B}; got {tuple(page_tables.shape)}, "
            f"{tuple(ctx_lens.shape)}, {tuple(start_pos.shape)}")
    for name, t in (("page_tables", page_tables), ("ctx_lens", ctx_lens),
                    ("start_pos", start_pos)):
        if t.dtype != torch.int32:
            raise MXNetError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool),
                    ("page_tables", page_tables), ("ctx_lens", ctx_lens),
                    ("start_pos", start_pos)):
        if t.device != q.device:
            raise MXNetError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise MXNetError(f"ragged_paged_attention kernel needs a "
                             f"contiguous {name}")
    if window is not None and int(window) < 0:
        raise MXNetError(f"window must be >= 0, got {window}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _, ps, Hkv, _ = kpool.shape
    err = _kernel_fn()(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
        page_tables.data_ptr(), ctx_lens.data_ptr(), start_pos.data_ptr(),
        out.data_ptr(), B, H, Hkv, C, D, ps, page_tables.shape[1],
        -1 if window is None else int(window), float(scale),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise MXNetError(f"ragged_paged_attention kernel launch failed "
                         f"(cudaError_t {err})")
    _kernels.LAUNCHES["ragged_paged_attention"] += 1
    return out


def ragged_paged_attention(q, kpool, vpool, page_tables, ctx_lens,
                           start_pos, window=None, scale=None):
    """Mixed prefill/decode attention over a paged KV pool — one launch.

    q: (B, H, C, D) chunk queries (C = 1 for a pure-decode step);
    kpool/vpool: (num_pages, page_size, Hkv, D); page_tables:
    (B, max_pages) int32 physical-page ids per logical page; ctx_lens:
    (B,) valid context length INCLUDING this chunk's tokens (already
    written to the pool); start_pos: (B,) absolute position of each
    slot's first chunk token.  Rows past a slot's real token count
    produce causally-valid garbage the caller must ignore.

    A CUDA tensor launches K1 (or raises); a CPU tensor runs
    `paged_attention_reference`.
    """
    H, D = q.shape[1], q.shape[3]
    Hkv = kpool.shape[2]
    if H % Hkv:
        raise MXNetError(f"query heads ({H}) must be a multiple of pool "
                         f"kv heads ({Hkv})")
    if q.device.type == "cuda":
        return _rpa_cuda(q, kpool, vpool, page_tables, ctx_lens, start_pos,
                         window,
                         scale if scale is not None else 1.0 / math.sqrt(D))
    if q.device.type != "cpu":
        raise MXNetError(f"ragged_paged_attention runs on cuda or cpu, "
                         f"not {q.device}")
    return paged_attention_reference(q, kpool, vpool, page_tables, ctx_lens,
                                     start_pos, window=window, scale=scale)
