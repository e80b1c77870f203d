"""Ragged paged attention for the serving stack: CUDA kernel + plain torch.

Counterpart of ``mxnet_tpu/ops/pallas/paged_attention.py``.  ONE launch
handles a mixed continuous-batching step — some slots mid-prefill (a chunk
of C query tokens), others decoding (one query token) — attending over a
**paged KV pool** ``(num_pages, page_size, Hkv, D)``; each slot's logical
context is the concatenation of the pages its page table names.

- On a CUDA tensor, `ragged_paged_attention` launches the hand-written
  kernel ``csrc/paged_attention.cu`` (K1) with the launch plan `_plan`
  makes from the shapes.  It splits each slot's key walk across blocks
  and merges the splits in order, reads only the keys below a slot's
  context length, folds the GQA query heads onto rows so K/V stream once
  per kv head, and keeps an f32 online softmax per row.  Queries and the
  pool share a dtype (f32, bf16 or f16), or f32 queries read a bf16 or
  f16 pool (a 16-bit model's serving step, whose activations are f32
  after the first LayerNorm): K/V then widen to f32 as they load and the
  rest is the f32 route's.  An
  int8 pool (``k_scales`` / ``v_scales``: one f32 scale a stored vector,
  ``ServeConfig(kv_dtype="int8")``) launches the kernel's int8 variant
  under f32 or bf16 queries: it reads int8 rows and their scales and
  never writes a dequantized row (the JAX package sends such pools
  through its gather reference); an int8 pool under f16 queries, which
  no path makes, raises by name.  It raises on what the kernel does not
  take; it never falls back.  Each launch counts under its pool's dtype
  (`kernels.DTYPE_LAUNCHES`).
- The pool's page size is this kernel's tunable, as in the JAX package:
  `recommended_page_size` is what `serve.ServeConfig` takes when
  ``MXTPU_SERVE_PAGE_SIZE`` is unset.
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
import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..base import MXNetError
from .. import kernels as _kernels
from . import autotune

MASK_VALUE = -1e30

__all__ = ["ragged_paged_attention", "paged_attention_reference",
           "gather_pages", "recommended_page_size", "MASK_VALUE"]


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
    flow, step for step; the products promote as ``jnp.einsum`` does
    (f32 queries over a bf16 cache compute in f32).
    """
    B, H, C, D = q.shape
    Hkv, T = kc.shape[1], kc.shape[2]
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(
            float(D), dtype=torch.float32, device=q.device)).to(q.dtype)
    rep = H // Hkv
    dt = torch.promote_types(q.dtype, kc.dtype)
    qg = q.reshape(B, Hkv, rep * C, D).to(dt)
    s = (qg @ kc.to(dt).transpose(-1, -2)).reshape(B, H, C, T) * scale
    t_idx = torch.arange(T, device=q.device)[None, None, None, :]
    pos = q_pos[:, None, :, None]
    mask = t_idx <= pos
    if ctx_len is not None:
        mask &= t_idx < ctx_len[:, None, None, None]
    if window is not None:
        mask &= t_idx >= pos - window
    # JAX's weakly typed MASK_VALUE takes the scores' dtype: -inf in f16
    # (the card's torch.where refuses to round a Python -1e30 into f16)
    s = torch.where(mask, s, torch.tensor(MASK_VALUE, device=s.device)
                    .to(s.dtype))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    dt = torch.promote_types(p.dtype, vc.dtype)
    ctx = p.reshape(B, Hkv, rep * C, T).to(dt) @ vc.to(dt)
    return ctx.reshape(B, H, C, D)


# ---------------------------------------------------------------------------
# page gathering + the plain version of K1
# ---------------------------------------------------------------------------

def gather_pages(pool, page_tables, scales=None):
    """Materialise each slot's logical context from the paged pool.

    pool: (num_pages, page_size, Hkv, D); page_tables: (B, max_pages)
    int32 (unallocated entries may point anywhere — callers mask by
    ctx_len).  Returns (B, max_pages * page_size, Hkv, D).  `scales`
    (num_pages, page_size, Hkv) dequantizes an int8 pool to f32 on the
    way: only the gathered context, never the whole pool."""
    tables = page_tables.long()
    g = pool[tables]                              # (B, maxp, ps, Hkv, D)
    B, maxp, ps, Hkv, D = g.shape
    g = g.reshape(B, maxp * ps, Hkv, D)
    if scales is not None:
        g = g.float() * scales[tables].reshape(B, maxp * ps, Hkv, 1)
    return g


def paged_attention_reference(q, kpool, vpool, page_tables, ctx_lens,
                              start_pos, window=None, scale=None,
                              k_scales=None, v_scales=None, out_dtype=None):
    """Plain version of K1: gather the page table to a contiguous context
    (dequantized in f32 for an int8 pool), cast it to ``out_dtype`` or
    q's dtype, and run `_dense_attend`.  The CPU path and the kernel's
    oracle."""
    B, H, C, D = q.shape
    q_pos = start_pos[:, None] + torch.arange(C, device=q.device)[None, :]
    dt = out_dtype or q.dtype
    # (B, L, Hkv, D) -> (B, Hkv, L, D)
    kc = gather_pages(kpool, page_tables, k_scales).to(dt).permute(
        0, 2, 1, 3)
    vc = gather_pages(vpool, page_tables, v_scales).to(dt).permute(
        0, 2, 1, 3)
    return _dense_attend(q.to(dt), kc, vc, q_pos, ctx_len=ctx_lens,
                         window=window, scale=scale)


# ---------------------------------------------------------------------------
# K1: the CUDA kernel (csrc/paged_attention.cu) and its launch plan
# ---------------------------------------------------------------------------

TILE_ROWS = 16        # rows of the tensor-core variant; fewer take "few"
KEY_TILE = 16         # keys a warp takes a step of its walk
MAX_SPAN = 256        # most keys a split covers (rounded down to pages)
MAX_SPLITS = 128      # most splits (the kernel keeps their weights)
RING_BYTES = 80 * 1024  # shared memory the warps' K/V rings may fill
MAX_HEAD_DIM = 256    # the widest row the kernel's tiles hold


class Plan(NamedTuple):
    """One K1 launch: the variant, its rows a block, the key split, the
    warps a block, and what the wrapper allocates for it."""
    variant: str     # "few" (rep * C < 16: decode) or "tile" (mma.sync)
    row_tile: int    # query rows a block: all of them (few) or 16 (tile)
    span: int        # keys a split covers, a whole number of pages
    split: int       # blocks along the keys; partials merged in order
    warps: int       # warps a block, each walking its own key tiles
    groups: int      # (slot * kv head, row tile) pairs: one ticket each
    workspace: int   # f32 partials (0 with one split)


@functools.lru_cache(maxsize=256)
def _plan(B: int, H: int, Hkv: int, C: int, D: int, ps: int, maxp: int,
          dtype, sm_count: int) -> Plan:
    """The launch plan of one K1 call, plain Python (no card needed),
    memoised per shape; `dtype` is the pool's, whose rows fill the rings
    (int8 rows a quarter of f32's: the int8 variant always fits 4 warps).

    The few-rows variant below 16 folded rows (``rep * C``), else the
    tile variant, 16 rows a block.  Warps a block: as many (up to 4) as
    fit their two-stage K/V rings in 80 KB.  The key split works from the
    table's capacity ``maxp * ps``, which the host knows without a sync: it
    aims at eight blocks an SM over the (slot * kv head, row tile) groups,
    each split a whole number of pages, at least one 16-key tile a warp
    and at most 256 keys (a page, where pages are larger), and at most
    128 splits."""
    rows = (H // Hkv) * C
    variant = "few" if rows < TILE_ROWS else "tile"
    row_tile = rows if variant == "few" else TILE_ROWS
    item = {"bfloat16": 2, "float16": 2, "int8": 1}.get(
        autotune.dtype_name(dtype), 4)
    dmax = 64 if D <= 64 else 128 if D <= 128 else 256
    pad = 32 if variant == "few" else 16
    warps = max(1, min(4, RING_BYTES // (2 * 2 * KEY_TILE
                                          * (dmax * item + pad))))
    groups = B * Hkv * -(-rows // row_tile)
    cap = maxp * ps
    pages = -(-cap // max(1, -(-8 * sm_count // groups)) // ps)
    lo = max(-(-warps * KEY_TILE // ps), -(-maxp // MAX_SPLITS))
    hi = max(lo, MAX_SPAN // ps)
    span = min(max(pages, lo), hi, maxp) * ps
    split = -(-cap // span)
    # a partial row: acc[D] (D rounded up to 4), m, l and two floats of
    # pad (16-byte rows)
    return Plan(variant, row_tile, span, split, warps, groups,
                groups * split * row_tile * (-(-D // 4) * 4 + 4)
                if split > 1 else 0)


_P = ctypes.c_void_p
_I = ctypes.c_int
_fns: Dict[str, Any] = {}
# (pool dtype, query dtype) -> the C entry's `types` code; 3 and 4 are the
# int8 variant, whose pools carry f32 scale planes
_TYPES = {(torch.float32, torch.float32): 0,
          (torch.bfloat16, torch.bfloat16): 1,
          (torch.bfloat16, torch.float32): 2,
          (torch.int8, torch.float32): 3,
          (torch.int8, torch.bfloat16): 4,
          (torch.float16, torch.float32): 5,
          (torch.float16, torch.float16): 6}
# the library of each query dtype's types (`kernels.SPLITS`)
_LIBRARY = {torch.float32: "paged_attention_q32",
            torch.bfloat16: "paged_attention_q16",
            torch.float16: "paged_attention_q16"}
# (device index, raw stream) -> (ticket counters, f32 partials workspace)
_scratch_of: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}
# operand shapes, dtypes and devices already checked -> their plan
_checked: Dict[Any, Plan] = {}


def _kernel_fn(q_dtype):
    """The C entry of the library that holds `q_dtype`'s types."""
    name = _LIBRARY[q_dtype]
    f = _fns.get(name)
    if f is None:
        f = _kernels.load(name).mxt_ragged_paged_attention
        f.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I, _I,
                      _I, _P, _P, _P]
        f.restype = _I
        _fns[name] = f
    return f


def _check(q, kpool, vpool, page_tables, ctx_lens, start_pos,
           k_scales=None, v_scales=None) -> Plan:
    """The operands' dtypes, shapes and devices, checked once per key of
    them (a decode step makes one call a layer with the same key); returns
    the call's plan."""
    B, H, C, D = q.shape
    if q.dtype not in _LIBRARY:
        raise MXNetError(f"ragged_paged_attention kernel takes float32, "
                         f"bfloat16 or float16 queries, got {q.dtype}")
    if kpool.dtype == torch.int8 and q.dtype == torch.float16:
        raise MXNetError(
            "ragged_paged_attention kernel: an int8 pool under float16 "
            "queries is not taken (no serving path makes it: an f16 "
            "model's decode step queries in f32)")
    if kpool.dtype != vpool.dtype or (kpool.dtype, q.dtype) not in _TYPES:
        raise MXNetError(
            f"ragged_paged_attention kernel needs pools in the query dtype, "
            f"a bfloat16 pool under float32 queries, a float16 pool under "
            f"float32 queries, or an int8 pool under float32 or bfloat16 "
            f"queries; got {kpool.dtype}/{vpool.dtype} under {q.dtype}")
    if kpool.dim() != 4 or kpool.shape != vpool.shape or \
            kpool.shape[3] != D:
        raise MXNetError(
            f"pools must both be (num_pages, page_size, Hkv, {D}); got "
            f"{tuple(kpool.shape)} and {tuple(vpool.shape)}")
    quantized = kpool.dtype == torch.int8
    if quantized != (k_scales is not None) or \
            quantized != (v_scales is not None):
        raise MXNetError(
            "ragged_paged_attention kernel: an int8 pool needs k_scales and "
            "v_scales, a float pool takes neither")
    if quantized:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if t.dtype != torch.float32 or t.shape != kpool.shape[:3] or \
                    t.device != q.device:
                raise MXNetError(
                    f"{name} must be float32 {tuple(kpool.shape[:3])} on "
                    f"{q.device}; got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise MXNetError(f"ragged_paged_attention kernel takes a head_dim "
                         f"of at most {MAX_HEAD_DIM}; got {D} (wider heads "
                         f"are ROADMAP B4 part 2)")
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
    for name, t in (("kpool", kpool), ("vpool", vpool),
                    ("page_tables", page_tables), ("ctx_lens", ctx_lens),
                    ("start_pos", start_pos)):
        if t.device != q.device:
            raise MXNetError(f"{name} is on {t.device}, q on {q.device}")
    _, ps, Hkv, _ = kpool.shape
    return _plan(B, H, Hkv, C, D, ps, page_tables.shape[1], kpool.dtype,
                 _kernels.sm_count(q.device))


def _rpa_cuda(q, kpool, vpool, page_tables, ctx_lens, start_pos, window,
              scale, plan: Optional[Plan] = None, k_scales=None,
              v_scales=None):
    """Check the operands, then launch K1 on the current stream with
    `plan` (default: `_plan`'s for these shapes); an int8 pool with its
    scale planes launches the int8 variant."""
    key = (q.shape, kpool.shape, vpool.shape, page_tables.shape,
           ctx_lens.shape, start_pos.shape, q.dtype, kpool.dtype,
           vpool.dtype, page_tables.dtype, ctx_lens.dtype, start_pos.dtype,
           q.device, kpool.device, vpool.device, page_tables.device,
           ctx_lens.device, start_pos.device,
           *(None if t is None else (t.shape, t.dtype, t.device)
             for t in (k_scales, v_scales)))
    checked = _checked.get(key)
    if checked is None:
        checked = _checked[key] = _check(q, kpool, vpool, page_tables,
                                         ctx_lens, start_pos, k_scales,
                                         v_scales)
    plan = plan or checked
    tensors = (q, kpool, vpool, page_tables, ctx_lens, start_pos)
    if k_scales is not None:
        tensors += (k_scales, v_scales)
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError("ragged_paged_attention kernel needs contiguous "
                         "q, pools, scales, page_tables, ctx_lens and "
                         "start_pos")
    if window is not None and int(window) < 0:
        raise MXNetError(f"window must be >= 0, got {window}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if (q.data_ptr() | kpool.data_ptr() | vpool.data_ptr()) & 15:
        raise MXNetError("ragged_paged_attention kernel needs q and the "
                         "pools on 16-byte boundaries")
    B, H, C, D = q.shape
    _, ps, Hkv, _ = kpool.shape
    dev = q.device
    # the raw handle, without building a torch.cuda.Stream each call
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ws = cnt = None
    if plan.split > 1:
        cnt, ws = _kernels.stream_scratch(_scratch_of, dev, stream,
                                          plan.groups, plan.workspace)
        cnt, ws = cnt.data_ptr(), ws.data_ptr()
    quantized = k_scales is not None
    err = _kernel_fn(q.dtype)(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        page_tables.data_ptr(), ctx_lens.data_ptr(), start_pos.data_ptr(),
        out.data_ptr(), B, H, Hkv, C, D, ps, page_tables.shape[1],
        -1 if window is None else int(window), float(scale),
        _TYPES[kpool.dtype, q.dtype], plan.variant == "tile", plan.row_tile,
        plan.span, plan.split, plan.warps, ws, cnt, stream)
    if err:
        raise MXNetError(f"ragged_paged_attention kernel launch failed "
                         f"(cudaError_t {err}, {plan})")
    _kernels.count_launch("ragged_paged_attention_int8" if quantized
                          else "ragged_paged_attention", kpool.dtype)
    return out


def ragged_paged_attention(q, kpool, vpool, page_tables, ctx_lens,
                           start_pos, window=None, scale=None,
                           k_scales=None, v_scales=None):
    """Mixed prefill/decode attention over a paged KV pool — one launch.

    q: (B, H, C, D) chunk queries (C = 1 for a pure-decode step);
    kpool/vpool: (num_pages, page_size, Hkv, D); page_tables:
    (B, max_pages) int32 physical-page ids per logical page; ctx_lens:
    (B,) valid context length INCLUDING this chunk's tokens (already
    written to the pool); start_pos: (B,) absolute position of each
    slot's first chunk token.  Rows past a slot's real token count
    produce causally-valid garbage the caller must ignore.  k_scales /
    v_scales: (num_pages, page_size, Hkv) f32 for an int8 pool.

    A CUDA tensor launches K1 — its int8 variant for an int8 pool — or
    raises; a CPU tensor runs `paged_attention_reference`.
    """
    H, D = q.shape[1], q.shape[3]
    Hkv = kpool.shape[2]
    if H % Hkv:
        raise MXNetError(f"query heads ({H}) must be a multiple of pool "
                         f"kv heads ({Hkv})")
    if q.device.type == "cuda":
        return _rpa_cuda(q, kpool, vpool, page_tables, ctx_lens, start_pos,
                         window,
                         scale if scale is not None else 1.0 / math.sqrt(D),
                         k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cpu":
        raise MXNetError(f"ragged_paged_attention runs on cuda or cpu, "
                         f"not {q.device}")
    return paged_attention_reference(q, kpool, vpool, page_tables, ctx_lens,
                                     start_pos, window=window, scale=scale,
                                     k_scales=k_scales, v_scales=v_scales)


# ---------------------------------------------------------------------------
# autotune registration: K1's plan follows from the shapes, so the tunable
# knob is the POOL's page size, as in the JAX package —
# `tune("paged_attention", (slots, heads, kv_heads, head_dim, ctx))` times a
# serving-shaped decode step per candidate and `serve.ServeConfig` picks the
# kept winner up when MXTPU_SERVE_PAGE_SIZE is unset.
# ---------------------------------------------------------------------------

PAGE_SIZES = (16, 32, 64, 128)


def recommended_page_size(default: int = 16) -> int:
    """The tuned page size for this device kind (or `default`): any kept
    ``tune("paged_attention", ...)`` result applies, whatever serving
    shape it was searched under."""
    cfg = autotune.lookup_any("paged_attention")
    return int(cfg.page_size) if cfg is not None else default


def _at_shapes(shapes):
    return (list(shapes) + [8, 8, 8, 64, 512])[:5]


def _at_candidates(shapes, dtype):
    return [autotune.BlockConfig(page_size=ps) for ps in PAGE_SIZES]


def _at_roofline(config, shapes, dtype):
    """JAX's count (`mxnet_tpu/ops/pallas/paged_attention.py`
    `_at_roofline`): each slot streams ceil(ctx / ps) pages of K and V at 4
    bytes; one step per (slot, kv head, page)."""
    b, h, hkv, d, ctx = _at_shapes(shapes)
    ps = config.page_size
    pages = max(1, -(-ctx // ps))
    return {"flops": 4.0 * b * h * ctx * d,
            "bytes": b * hkv * pages * ps * d * 2.0 * 4,
            "steps": float(b * hkv * pages)}


def _at_inputs(config, shapes, dtype, device):
    """A serving-shaped decode step's operands (C = 1, every slot at
    ``ctx`` keys) over a seeded pool of the candidate's page size, as the
    JAX package's `_at_build` makes them."""
    import numpy as np
    b, h, hkv, d, ctx = _at_shapes(shapes)
    ps = config.page_size
    maxp = max(1, -(-ctx // ps))
    n_pages = b * maxp + 1
    rng = np.random.RandomState(0)
    dt = _tune_dtype(dtype)

    def seeded(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            device, dt)

    q = seeded(b, h, 1, d)
    kpool = seeded(n_pages, ps, hkv, d)
    vpool = seeded(n_pages, ps, hkv, d)
    pt = torch.arange(1, b * maxp + 1, dtype=torch.int32,
                      device=device).reshape(b, maxp)
    ctx_lens = torch.full((b,), ctx, dtype=torch.int32, device=device)
    return q, kpool, vpool, pt, ctx_lens, ctx_lens - 1


def _tune_dtype(dtype) -> torch.dtype:
    """The trial's queries and pools: the key's own dtype (f32, bf16 or
    f16: an f16 key times the f16 pool's instantiation)."""
    return {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(
        autotune.dtype_name(dtype), torch.float32)


def _at_build(config, shapes, dtype):
    """The trial launch: `ragged_paged_attention` over `_at_inputs` — K1
    on the card (it counts in `kernels.LAUNCHES`), the plain version on
    the CPU.  Returns the thunk."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    args = _at_inputs(config, shapes, dtype, dev)
    return lambda: ragged_paged_attention(*args)


autotune.register_tunable("paged_attention", _at_candidates, _at_build,
                          _at_roofline)
