"""Flash attention, forward and backward: CUDA kernel + plain torch.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py``: blockwise
online-softmax attention over (B, H, L, D) that never keeps the (L, L)
probabilities for the backward — it saves the f32 logsumexp per row and
recomputes.  `flash_attention` is a `torch.autograd.Function`:

- on a CUDA tensor it launches the hand-written kernels of
  ``csrc/flash_attention.cu`` (forward: one tensor-core pass per q tile,
  its tiles from `resolve_blocks` through `_fwd_plan`; backward: a di row
  pass, then one tensor-core pass per key tile for dQ, dK and dV, laid out
  by `_bwd_plan`; both skip the tiles outside a sliding window's band and
  take grouped K/V folded onto the row axis), in f32, bf16 or f16 (each
  type its own library, `kernels.SPLITS`), or raises `MXNetError` on what
  they do not take (heads over 256 wide, another dtype);
- on a CPU tensor it runs `flash_fwd_reference` / `flash_bwd_reference`:
  the same arithmetic in plain torch, which the CPU tests hold against the
  JAX package; the block sizes change nothing there.

The forward's block sizes follow JAX's `resolve_blocks`: explicit
``block_q`` / ``block_k``, then ``MXTPU_FLASH_BLOCK_Q`` / ``_K``, then the
autotuner's ``flash_attention`` config for the shape, then the card's
default plan.  The tunable is registered here, as in JAX.

`flash_attention_reference` runs those plain versions under the same
autograd on any device, by name: the oracle a run on the card is held
against (as `paged_attention_reference` is for the serving kernel).

Semantics kept from the JAX kernels: an additive f32 bias (key padding as
a compact (B, 1, Lk) row, or per query row), causal masking, a sliding
window, grouped K/V heads (the query heads of a group folded onto the row
axis, row r at position r % Lq, K/V never expanded), fully masked
rows giving zeros with lse = 0 and zero gradients, and attention-probs
dropout from the counter hash `keep_mask` — bit for bit the JAX
`_keep_mask`, keyed on the int32 seed, the flattened batch·head index and
the absolute row and column, so the forward and the backward kernel
regenerate one mask without storing it.  The bias gets a zero cotangent.
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..base import MXNetError
from .. import kernels as _kernels
from .. import tracing as _tracing
from . import autotune

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_fwd_reference", "flash_bwd_reference", "normalize_bias",
           "keep_mask", "resolve_blocks", "MASK_VALUE"]

MASK_VALUE = -1e30
_M32 = 0xFFFFFFFF
MAX_HEAD_DIM = 256      # the kernels' shared-memory tiles hold D <= 256


# ---------------------------------------------------------------------------
# the dropout hash (uint32 arithmetic carried in int64)
# ---------------------------------------------------------------------------

def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 tensors holding uint32 values, split
    into 16-bit halves of `c` so no product leaves int64's range (torch on
    the CPU has no uint32 arithmetic for these ops)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _splitmix32(x):
    """32-bit splitmix finalizer (``_splitmix32`` of the JAX kernel)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask(seed, bh, row0, col0, shape, rate, device=None):
    """Dropout keep mask of the JAX kernel's ``_keep_mask``, bit for bit.

    `seed`: int32 scalar (int or tensor); `bh`: flattened batch·head index
    (int, or an int tensor whose shape leads the result's); rows
    ``row0 ..`` and columns ``col0 ..`` are absolute positions; `shape` is
    (rows, cols).  Returns a bool tensor, True = keep."""
    if device is None:
        device = seed.device if torch.is_tensor(seed) else "cpu"
    i64 = dict(dtype=torch.int64, device=device)
    s = torch.as_tensor(seed, **i64).reshape(()) & _M32
    b = torch.as_tensor(bh, **i64)
    base = _splitmix32((s + _mul32(b & _M32, 0x27D4EB2F)) & _M32)
    base = base.reshape(base.shape + (1, 1))
    r = (torch.arange(shape[0], **i64) + row0) & _M32
    c = (torch.arange(shape[1], **i64) + col0) & _M32
    u = _splitmix32((_mul32(r[:, None], 0x9E3779B1)
                     + _mul32(c[None, :], 0x85EBCA77) + base) & _M32)
    return u >= min(2 ** 32 - 1, int(rate * 4294967296.0))


# ---------------------------------------------------------------------------
# bias normalisation and the plain versions
# ---------------------------------------------------------------------------

def normalize_bias(bias, b, h, lq, lk):
    """An additive bias as rank-3 (Bb, 1|Lq, Lk) f32 (``_normalize_bias``).

    Accepted shapes: (B, Lk), (B, 1|Lq, Lk), (B, 1|H, 1|Lq, Lk).  Returns
    (bias3, per_head, per_row)."""
    bb = torch.as_tensor(bias).to(torch.float32)
    if bb.dim() == 2:
        bb = bb[:, None, :]
    elif bb.dim() == 4:
        if bb.shape[1] == 1:
            bb = bb[:, 0]
        else:
            bb = bb.expand(b, h, bb.shape[2], bb.shape[3]).reshape(
                b * h, bb.shape[2], bb.shape[3])
    if bb.dim() != 3 or bb.shape[-1] != lk:
        raise ValueError(f"unsupported attention bias shape "
                         f"{tuple(torch.as_tensor(bias).shape)}")
    if bb.shape[0] not in (b, b * h):
        raise ValueError(f"bias batch dim {bb.shape[0]} != {b} or {b * h}")
    per_head = bb.shape[0] != b
    if bb.shape[1] == 1:
        per_row = False
    elif bb.shape[1] == lq:
        per_row = True
    else:
        raise ValueError(f"bias row dim {bb.shape[1]} != 1 or {lq}")
    return bb.contiguous(), per_head, per_row


def _scores(q, k, bias3, scale, causal, per_head, window, window_symmetric,
            lq):
    """Masked f32 scores (B, G, R, Lk) of folded queries q (B, G, R, D)
    against k (B, G, Lk, D); row r sits at position r % lq."""
    B, G, R, _ = q.shape
    lk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias3 is not None:
        bb = bias3.reshape(B, G if per_head else 1, bias3.shape[1], lk)
        if bb.shape[2] not in (1, R):       # per-row bias under the fold
            bb = bb.repeat(1, 1, R // bb.shape[2], 1)
        s = s + bb
    pos = torch.arange(R, device=q.device) % lq
    cols = torch.arange(lk, device=q.device)
    if causal:
        s = torch.where(cols[None, :] <= pos[:, None], s, MASK_VALUE)
    if window is not None:
        keep = cols[None, :] >= pos[:, None] - window
        if window_symmetric and not causal:
            keep &= cols[None, :] <= pos[:, None] + window
        else:
            keep &= cols[None, :] <= pos[:, None]
        s = torch.where(keep, s, MASK_VALUE)
    return s


def _probs(s, lse, hard_mask):
    p = torch.exp(s - lse[..., None])
    if hard_mask:
        # hard-masked scores contribute exactly 0, even in a fully masked
        # row (whose lse is 0)
        p = torch.where(s > 0.5 * MASK_VALUE, p, 0.0)
    return p


def _dropout_keep(seed, rate, B, G, R, lk, device):
    keep = keep_mask(seed, torch.arange(B * G, device=device), 0, 0,
                     (R, lk), rate, device=device)
    return keep.reshape(B, G, R, lk)


def flash_fwd_reference(q, k, v, bias3=None, seed=None, scale=None,
                        causal=False, rate=0.0, per_head=False,
                        per_row=False, window=None, window_symmetric=True,
                        lq=None):
    """Plain version of the forward kernel: returns (out, lse).

    q (B, G, R, D) with R = rep * lq grouped query rows (R = lq, G = H
    without GQA), k/v (B, G, Lk, D); bias3 from `normalize_bias`; lse is
    (B * G, R) f32.  Scores, softmax and the lse in f32; p is rounded to
    v's type before P·V, as in the kernel."""
    B, G, R, D = q.shape
    lk = k.shape[2]
    lq = R if lq is None else lq
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = _scores(q, k, bias3, scale, causal, per_head, window,
                window_symmetric, lq)
    m = s.amax(dim=-1)
    hard = bias3 is not None or window is not None
    p = _probs(s, m, hard)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, 1.0, l)
    lse = torch.where(l == 0.0, 0.0, m + torch.log(l_safe))
    if rate > 0.0:
        keep = _dropout_keep(seed, rate, B, G, R, lk, q.device)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe[..., None]
    return o.to(q.dtype), lse.reshape(B * G, R)


def flash_bwd_reference(q, k, v, bias3, seed, o, lse, g, scale=None,
                        causal=False, rate=0.0, per_head=False,
                        per_row=False, window=None, window_symmetric=True,
                        lq=None):
    """Plain version of the backward kernels: returns (dq, dk, dv) from the
    forward's `o` and `lse` and the output cotangent `g`, recomputing p
    from lse (``_dq_kernel`` / ``_dkv_kernel``)."""
    B, G, R, D = q.shape
    lk = k.shape[2]
    lq = R if lq is None else lq
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = _scores(q, k, bias3, scale, causal, per_head, window,
                window_symmetric, lq)
    hard = bias3 is not None or window is not None
    p = _probs(s, lse.reshape(B, G, R), hard)
    gf = g.float()
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    pd = p
    if rate > 0.0:
        keep = _dropout_keep(seed, rate, B, G, R, lk, q.device)
        inv = 1.0 / (1.0 - rate)
        dp = torch.where(keep, dp * inv, 0.0)
        pd = torch.where(keep, p * inv, 0.0)
    di = (gf * o.float()).sum(dim=-1)          # rowsum(dO * O)
    ds = p * (dp - di[..., None]) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dv = torch.matmul(pd.to(g.dtype).float().transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

# the forward's tiles (csrc/flash_attention.cu `flash_fwd_kernel`): query
# rows a work item (a block of 4 or 8 warps of 16 rows) and keys a stage of
# the K/V ring
FWD_TILES = (64, 128)
SMEM_BLOCK = 232448     # the shared memory an H100 block may use (227 KB)


def _is_16bit(dtype) -> bool:
    """bf16 or f16 (the plans treat both alike: same bytes, same tiles)."""
    return "16" in str(dtype)


# the kernels' input type codes (the C entry points' `dtype`, numbered as
# `ops.fused_norm` numbers them) and the library each type is built into
# (`kernels.SPLITS`)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIBRARY = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16",
            torch.float16: "flash_attention_f16"}


def _torch_dtype(dtype) -> torch.dtype:
    """A dtype or its name (a tuning key's "bfloat16", "float16", ...)
    as the torch dtype; any other name is f32."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(
        str(dtype).replace("torch.", ""), torch.float32)


def _dmax(D: int) -> int:
    """The width the kernels' tiles pad a head of D columns to."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def _fwd_smem(dtype, dmax: int, bq: int, bk: int) -> int:
    """Shared memory of one forward block: two Q tiles (an item's and the
    next one's) and a two-stage ring of K and V tiles, rows padded by 16
    bytes (bf16, f16) or 4 floats (f32)."""
    item, pad = (2, 8) if _is_16bit(dtype) else (4, 4)
    return item * (2 * bq + 4 * bk) * (dmax + pad)


class FwdPlan(NamedTuple):
    """One forward launch: the tiles and where they came from."""
    bq: int              # query rows a work item (a block of bq / 16 warps)
    bk: int              # keys a stage of the K/V ring
    dmax: int            # D padded to 64, 128 or 256
    smem: int            # bytes of shared memory a block
    items: int           # work items, B * H * ceil(Lq / bq)
    grid: int            # persistent blocks; 0: as many as fit on the card
                         # at once (the kernel's occupancy times the SMs)
    source: str          # "explicit", "env", "tuned" or "default" (q/k
                         # joined by "/" when they differ)


def _fwd_plan(B: int, H: int, Lq: int, Lk: int, D: int, dtype,
              block_q: int, block_k: int, source: str = "explicit",
              kv_heads: Optional[int] = None) -> FwdPlan:
    """The forward's launch for the blocks `resolve_blocks` gave, plain
    Python.  A block size snaps to the card's tiles (128 from 128 up, else
    64), as JAX fits its blocks to the sequence.  Heads over 64 wide take
    64-row items (their warps need over 128 registers, so an SM holds one
    block of 8 warps or two of 4: the smaller items balance better), and
    where the tiles exceed a block's shared memory (f32 heads over 64 wide
    at 128 keys) the key tile halves.  Heads over 128 wide take the one
    pair that fits: 64 x 64 in 16 bits, 32 x 32 in f32 (whatever the blocks
    asked).  With ``kv_heads`` g < H the H // g query heads of a group are
    folded onto the row axis: B * g heads of H // g * Lq rows."""
    dmax = _dmax(D)
    if dmax == 256:
        bq = bk = 64 if _is_16bit(dtype) else 32
    else:
        bq = 128 if int(block_q) >= 128 and dmax == 64 else 64
        bk = 128 if int(block_k) >= 128 else 64
        if _fwd_smem(dtype, dmax, bq, bk) > SMEM_BLOCK:
            bk = 64
    g = kv_heads or H
    return FwdPlan(bq, bk, dmax, _fwd_smem(dtype, dmax, bq, bk),
                   B * g * -(-(H // g) * Lq // bq), 0, source)


# the card's plan where nothing else chooses: 64-row items with 64-key
# stages, the smallest tiles, so the most blocks an SM (three in 16 bits) --
# the fastest of the four in both dtypes and all five masks of
# `chip_smoke.py` phase 6 at BERT's shape on an H100 (PERF.md)
DEFAULT_BLOCKS = (64, 64)


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _resolve(b, h, lq, lk, d, dtype, block_q, block_k):
    """`resolve_blocks` with each block's source."""
    cfg = None
    if block_q is None or block_k is None:
        if "MXTPU_FLASH_BLOCK_Q" not in os.environ or \
                "MXTPU_FLASH_BLOCK_K" not in os.environ:
            cfg = autotune.cached_config("flash_attention", (b, h, lq, lk, d),
                                         autotune.dtype_name(dtype))

    def pick(given, env, field, default):
        if given is not None:
            return int(given), "explicit"
        if env in os.environ:
            return _env_int(env, default), "env"
        if cfg is not None and field in cfg:
            return int(cfg[field]), "tuned"
        return default, "default"
    return (pick(block_q, "MXTPU_FLASH_BLOCK_Q", "block_q",
                 DEFAULT_BLOCKS[0]),
            pick(block_k, "MXTPU_FLASH_BLOCK_K", "block_k",
                 DEFAULT_BLOCKS[1]))


def resolve_blocks(b, h, lq, lk, d, dtype, block_q=None, block_k=None):
    """Pick (block_q, block_k) for one call, in JAX's order
    (``mxnet_tpu/ops/pallas/flash_attention.py`` `resolve_blocks`):
    explicit arguments win, then an explicitly set
    ``MXTPU_FLASH_BLOCK_Q`` / ``_K``, then the autotuner's kept config for
    the shape bucket (`tune("flash_attention", (b, h, lq, lk, d), dtype)`),
    then the card's default plan (`DEFAULT_BLOCKS`, where JAX has 256).
    Pure lookup."""
    (bq, _), (bk, _) = _resolve(b, h, lq, lk, d, dtype, block_q, block_k)
    return bq, bk


# plans already made, keyed by shape, dtype, device, the blocks asked for
# and the env overrides, valid for the autotuner generation in
# `_fwd_memo_gen`
_fwd_memo: Dict[Any, FwdPlan] = {}
_fwd_memo_gen = None


def _planned_fwd(B, H, Lq, Lk, D, dtype, device, block_q=None,
                 block_k=None, kv_heads=None) -> FwdPlan:
    """`_fwd_plan` for the blocks `resolve_blocks` picks, looked up once
    per key and `autotune.generation()`, not at each of a step's calls.
    The blocks resolve on the unfolded (B, H, Lq, Lk, D), JAX's key, also
    under grouped K/V (``kv_heads``)."""
    global _fwd_memo_gen
    gen = autotune.generation()
    if gen != _fwd_memo_gen:
        _fwd_memo.clear()
        _fwd_memo_gen = gen
    key = (B, H, Lq, Lk, D, dtype, device, block_q, block_k, kv_heads,
           os.environ.get("MXTPU_FLASH_BLOCK_Q"),
           os.environ.get("MXTPU_FLASH_BLOCK_K"))
    plan = _fwd_memo.get(key)
    if plan is None:
        (bq, sq), (bk, sk) = _resolve(B, H, Lq, Lk, D, dtype, block_q,
                                      block_k)
        plan = _fwd_memo[key] = _fwd_plan(
            B, H, Lq, Lk, D, dtype, bq, bk, sq if sq == sk else f"{sq}/{sk}",
            kv_heads)
    return plan


# the backward's tiles (csrc/flash_attention.cu `flash_bwd_kernel`)
BWD_KEY_TILES = (64, 128)   # keys a block holds: 4 or 8 warps of 16 keys
# the most q rows a backward block sums a key tile's dK and dV over: the
# tensor cores' f32 accumulation drifts by about 2^-24 of the sum an
# addition, 1.4e-4 of dK over the 8192 rows Gemma 2B's folded heads give a
# key on average; past this many rows a key tile's q tiles are split
# across blocks, whose f32 partials are summed in order
BWD_SPLIT_ROWS = 1024


def _bwd_key_tiles(dmax: int, dtype) -> Tuple[int, ...]:
    """The key tiles a backward block may hold at a padded width: both up
    to 128 columns; over that the one that fits a block's shared memory,
    64 keys in 16 bits and 32 in f32, with two warps a 16 keys (each
    accumulating dK and dV over half the columns)."""
    if dmax <= 128:
        return BWD_KEY_TILES
    return (64,) if _is_16bit(dtype) else (32,)


def _bwd_smem(dtype, dmax: int, bk: int) -> int:
    """Shared memory of one backward block (csrc `bwd_smem`): KVB K/V
    buffers (2 for 16 bits, 1 for f32) of bk rows, a two-stage ring of Q and
    dO tiles of bq rows, dS^T (bk x bq) and lse, di and positions for two
    q tiles."""
    item, pad = (2, 8) if _is_16bit(dtype) else (4, 4)
    kvb = 2 if _is_16bit(dtype) else 1
    bq = 64 if dmax == 64 else 32
    return item * ((2 * kvb * bk + 4 * bq) * (dmax + pad)
                   + bk * (bq + pad)) + 4 * 6 * bq


class BwdPlan(NamedTuple):
    """One backward launch: the key tile, the head width the tiles are
    padded to, the q rows a step of the walk, and what the wrapper
    allocates for it."""
    bk: int              # keys a block holds (64 or 128; 64 or 32 for
                         # heads over 128 wide)
    dmax: int            # D padded to 64, 128 or 256
    bq: int              # q rows a step: 64, or 32 for heads over 64 wide
    key_tiles: int       # work items a head; dQ partials when more than one
    q_tiles: int         # q tiles a head: one ticket each
    blocks: int          # work items (B * g * key_tiles * q_splits)
    grid: int            # blocks launched: one an item, or (16-bit with one
                         # key tile a head) one an SM, persistent
    tickets: int         # uint32 tickets (B * g * q_tiles), 0 with one tile
    workspace: int       # f32 dQ partials (key_tiles * B * H * Lq * D)
    q_splits: int        # blocks a key tile's q tiles are split across
    kv_tickets: int      # uint32 tickets (B * g * key_tiles), 0 unsplit
    kv_workspace: int    # f32 dK / dV partials (2 * bk * D a split)


def _bwd_plan(B: int, H: int, Lq: int, Lk: int, D: int, dtype,
              sm_count: int, bk: Optional[int] = None,
              kv_heads: Optional[int] = None) -> BwdPlan:
    """The launch plan of one backward call, plain Python (no card needed).

    The key tile is 128 keys (8 warps), so a head of up to 128 keys is one
    tile and the block writes dQ itself with no partials (BERT's L = 128);
    it is 64 where Lk fits in 64, or where 128-key tiles would leave the
    grid short of one block per SM.  ``bk`` overrides (the tests run both).
    16-bit with one key tile a head launches at most one block an SM, each
    walking items with the next one's loads in flight; otherwise one block
    an item (f32, whose tiles fill shared memory, always): with several key
    tiles a head the items differ in size (causal, a window) and blocks
    taken as they free up balance them, where a static walk does not --
    at GPT-2 small's L 1024 in bf16, 0.72 ms against 1.64 (PERF.md, the
    flash backward).  With ``kv_heads`` g < H a head is one of the B * g
    folded heads, of H // g * Lq rows (q tiles).  Heads over 128 wide
    take the one key tile that fits a block (`_bwd_key_tiles`).  A head
    of more than `BWD_SPLIT_ROWS` rows cuts each key tile's q tiles into
    that many rows a split or fewer, one block each, for the precision of
    dK and dV."""
    g = kv_heads or H
    heads, rows = B * g, H // g * Lq
    dmax = _dmax(D)
    tiles = _bwd_key_tiles(dmax, dtype)
    if bk is None:
        bk = 128
        if Lk <= 64 or heads * -(-Lk // 128) < sm_count:
            bk = 64
        if bk not in tiles:
            bk = tiles[0]
    if bk not in tiles:
        raise MXNetError(f"flash backward key tile must be one of "
                         f"{tiles} at head_dim {D}, got {bk}")
    bq = 64 if dmax == 64 else 32
    key_tiles = max(1, -(-Lk // bk))
    q_tiles = -(-rows // bq)
    per = -(-q_tiles // -(-rows // BWD_SPLIT_ROWS))   # q tiles a split
    q_splits = max(1, -(-q_tiles // per))
    split = key_tiles > 1
    items = heads * key_tiles * q_splits
    persistent = _is_16bit(dtype) and not split
    grid = min(items, sm_count) if persistent else items
    cut = q_splits > 1
    return BwdPlan(bk, dmax, bq, key_tiles, q_tiles, items, max(1, grid),
                   heads * q_tiles if split else 0,
                   key_tiles * heads * rows * D if split else 0, q_splits,
                   heads * key_tiles if cut else 0,
                   items * 2 * bk * D if cut else 0)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_fns = {}
# (device index, raw stream) -> (tickets, dQ partials, di, dK / dV
# partials): each stream keeps its own, grown on demand; every launch
# leaves the tickets zeroed
_scratch_of: Dict[Any, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _kernel_fn(direction, dtype):
    f = _fns.get((direction, dtype))
    if f is None:
        f = getattr(_kernels.load(_LIBRARY[dtype]),
                    f"mxt_flash_attention_{direction}")
        common = [_I] * 5 + [_F] + [_I] * 6 + [_F, _F, _U, _I]
        if direction == "fwd":
            f.argtypes = [_P] * 7 + common + [_I, _I, _I, _P]
        else:
            f.argtypes = [_P] * 16 + [_I] + common + [_I, _I, _P]
        f.restype = _I
        _fns[direction, dtype] = f
    return f


def _check(q, k, v, bias3, seed, rate, per_row, lq):
    """The kernels' operands: q (B, G, R, D) with R = rep * lq rows (the
    fold; R = lq without it), k/v (B, G, Lk, D), a bias of lq rows."""
    B, H, R, D = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise MXNetError(f"flash_attention kernel takes float32, bfloat16 "
                         f"or float16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(f"flash_attention kernel needs q, k and v in one "
                         f"dtype; got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise MXNetError(f"k and v must be ({B}, {H}, Lk, {D}); got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if lq < 1 or R % lq:
        raise MXNetError(f"{R} query rows are not a fold of length {lq}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {D} (wider heads are "
                         f"ROADMAP B4 part 2)")
    named = [("q", q), ("k", k), ("v", v)]
    if bias3 is not None:
        named.append(("bias", bias3))
        if bias3.dtype != torch.float32 or bias3.shape[1] != \
                (lq if per_row else 1):
            raise MXNetError(f"bias must be f32 (Bb, {lq if per_row else 1}"
                             f", Lk); got {bias3.dtype} "
                             f"{tuple(bias3.shape)}")
    if rate > 0.0:
        named.append(("dropout seed", seed))
        if seed.dtype != torch.int32 or seed.numel() != 1:
            raise MXNetError("the dropout seed must be one int32")
    for name, t in named:
        if t.device != q.device:
            raise MXNetError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise MXNetError(f"flash_attention kernel needs a contiguous "
                             f"{name}")


# a window past this reaches every key (the kernels' `NO_EDGE`)
_NO_EDGE = 1 << 30


def _common_args(q, k, bias3, scale, causal, rate, per_head, per_row,
                 window, window_symmetric, lq):
    B, H, R, D = q.shape
    mode = 0 if bias3 is None else (2 if per_row else 1)
    thresh = min(2 ** 32 - 1, int(rate * 4294967296.0)) if rate > 0 else 0
    inv = 1.0 / (1.0 - rate) if rate > 0 else 1.0
    win = -1 if window is None else min(int(window), _NO_EDGE)
    return [B * H, H, R, k.shape[2], D, float(scale), int(causal), win,
            int(bool(window_symmetric)), lq, mode, int(bool(per_head)),
            float(rate), inv, thresh, _DTYPE_CODE[q.dtype]]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _flash_fwd_cuda(q, k, v, bias3, seed, scale, causal, rate, per_head,
                    per_row, plan: Optional[FwdPlan] = None, window=None,
                    window_symmetric=True, lq=None):
    """Check the operands, then launch the forward kernel on the current
    stream with `plan` (default: `_planned_fwd` for the shape); returns
    (out, lse (B * G, R) f32).  q is (B, G, R, D), its rows folded from
    R // lq query heads a kv head when `lq` < R (`flash_fwd_reference`'s
    layout)."""
    B, G, R, D = q.shape
    lq = R if lq is None else lq
    _check(q, k, v, bias3, seed, rate, per_row, lq)
    out = torch.empty_like(q)
    lse = torch.empty((B * G, R), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse.zero_()
    if plan is None:
        plan = _planned_fwd(B, G * (R // lq), lq, k.shape[2], D, q.dtype,
                            q.device, kv_heads=G)
    err = _kernel_fn("fwd", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias3),
        _ptr(seed) if rate > 0 else None, out.data_ptr(), lse.data_ptr(),
        *_common_args(q, k, bias3, scale, causal, rate, per_head, per_row,
                      window, window_symmetric, lq),
        plan.bq, plan.bk, plan.grid,
        torch._C._cuda_getCurrentRawStream(q.device.index))
    if err:
        raise MXNetError(f"flash_attention forward kernel launch failed "
                         f"(cudaError_t {err}, {plan})")
    _kernels.count_launch("flash_attention_fwd", q.dtype)
    return out, lse


def _flash_bwd_cuda(q, k, v, bias3, seed, o, lse, g, scale, causal, rate,
                    per_head, per_row, plan: Optional[BwdPlan] = None,
                    window=None, window_symmetric=True, lq=None):
    """Check the operands, then launch the backward (the di row pass and
    the key-tile kernel) on the current stream with `plan` (default:
    `_bwd_plan` for the shape); returns (dq, dk, dv).  The layout is
    `_flash_fwd_cuda`'s."""
    B, G, R, D = q.shape
    lq = R if lq is None else lq
    _check(q, k, v, bias3, seed, rate, per_row, lq)
    for name, t in (("o", o), ("dout", g)):
        if t.shape != q.shape or t.dtype != q.dtype or \
                not t.is_contiguous() or t.device != q.device:
            raise MXNetError(f"{name} must be a contiguous {q.dtype} "
                             f"{tuple(q.shape)} on {q.device}")
    lk = k.shape[2]
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B * G, R) or \
            not lse.is_contiguous():
        raise MXNetError(f"lse must be contiguous f32 ({B * G}, {R})")
    # rows whose band holds no key (positions past lk - 1 + window) are
    # visited by no key tile: their dQ is zero, written here
    unseen = window is not None and lq - 1 - window > lk - 1
    dq = torch.zeros_like(q) if unseen else torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dev = q.device
    if plan is None:
        plan = _bwd_plan(B, G * (R // lq), lq, lk, D, q.dtype,
                         _kernels.sm_count(dev), kv_heads=G)
    # the raw handle, without building a torch.cuda.Stream each call
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    # the dQ tickets, then the dK / dV ones, in one zeroed buffer
    tickets, ws, di, kvws = _kernels.stream_scratch(
        _scratch_of, dev, stream, plan.tickets + plan.kv_tickets,
        plan.workspace, B * G * R, plan.kv_workspace)
    split, cut = plan.key_tiles > 1, plan.q_splits > 1
    err = _kernel_fn("bwd", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias3),
        _ptr(seed) if rate > 0 else None, o.data_ptr(), lse.data_ptr(),
        g.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ws.data_ptr() if split else None,
        tickets.data_ptr() if split else None,
        kvws.data_ptr() if cut else None,
        tickets.data_ptr() + 4 * plan.tickets if cut else None,
        plan.q_splits,
        *_common_args(q, k, bias3, scale, causal, rate, per_head, per_row,
                      window, window_symmetric, lq),
        plan.bk, plan.grid, stream)
    if err:
        raise MXNetError(f"flash_attention backward kernel launch failed "
                         f"(cudaError_t {err}, {plan})")
    _kernels.count_launch("flash_attention_bwd", q.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd and the dispatcher
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Saves q, k, v, the output and the f32 lse; the backward recomputes
    (``_flash`` and its custom VJP in the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, bias3, seed, scale, causal, rate, per_head,
                per_row, window, window_symmetric, lq, use_kernel, blocks):
        if use_kernel:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            B, G, R, D = q.shape
            # the blocks resolve on the unfolded shape, as in JAX
            plan = _planned_fwd(B, G * (R // lq), lq, k.shape[2], D,
                                q.dtype, q.device, *blocks, kv_heads=G)
            o, lse = _flash_fwd_cuda(q, k, v, bias3, seed, scale, causal,
                                     rate, per_head, per_row, plan, window,
                                     window_symmetric, lq)
            # the products' FLOPs, for a counting `tracing.FlopCount`
            # (which cannot see into the kernel): QK^T and PV
            _tracing.note_kernel_flops("flash_attention_fwd",
                                       4 * q.numel() * k.shape[2])
        else:
            o, lse = flash_fwd_reference(q, k, v, bias3, seed, scale, causal,
                                         rate, per_head, per_row, window,
                                         window_symmetric, lq)
        ctx.save_for_backward(q, k, v, bias3, seed, o, lse)
        ctx.cfg = (scale, causal, rate, per_head, per_row, window,
                   window_symmetric, lq, use_kernel)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias3, seed, o, lse = ctx.saved_tensors
        (scale, causal, rate, per_head, per_row, window, window_symmetric,
         lq, use_kernel) = ctx.cfg
        if use_kernel:
            dq, dk, dv = _flash_bwd_cuda(q, k, v, bias3, seed, o, lse,
                                         g.contiguous(), scale, causal, rate,
                                         per_head, per_row, None, window,
                                         window_symmetric, lq)
            # the recomputed QK^T and the four gradient products
            _tracing.note_kernel_flops("flash_attention_bwd",
                                       10 * q.numel() * k.shape[2])
        else:
            dq, dk, dv = flash_bwd_reference(q, k, v, bias3, seed, o, lse, g,
                                             scale, causal, rate, per_head,
                                             per_row, window,
                                             window_symmetric, lq)
        # the bias is a constant (masks): zero cotangent, as in JAX
        dbias = torch.zeros_like(bias3) if ctx.needs_input_grad[3] else None
        return (dq, dk, dv, dbias) + (None,) * 11


def flash_attention(q, k, v, causal=False, scale=None, block_q=None,
                    block_k=None, bias=None, dropout_rate=0.0,
                    dropout_seed=None, window=None, window_symmetric=True):
    """Flash attention over (B, H, L, D) tensors -> (B, H, Lq, D).

    `block_q` / `block_k` pick the forward kernel's tiles on the card (see
    `resolve_blocks`: then ``MXTPU_FLASH_BLOCK_Q`` / ``_K``, the tuned
    config, the card's plan); sizes snap to its 64 / 128 tiles
    (`_fwd_plan`).  The backward plans its own tiles (`_bwd_plan`), and the
    plain version ignores both.

    `bias` is an additive f32 logits bias (MASK_VALUE for hard masking) of
    a shape `normalize_bias` accepts; it gets a zero gradient.
    `dropout_rate` with an int32 `dropout_seed` (int or one-element tensor)
    applies attention-probs dropout inside the kernel, deterministic given
    the seed.  `window=w` keeps keys within w positions of the query
    ([q-w, q+w] when `window_symmetric` and not causal, else [q-w, q]).
    k/v may carry g < H heads (grouped-query attention, H % g == 0): the
    H // g query heads sharing a kv head are folded onto the row axis, and
    K/V stay at g heads (a per-head bias expands them, as in JAX).

    A CUDA tensor launches the kernels (they skip the key tiles outside
    the window's band); a CPU tensor runs the plain versions."""
    return _attend(q, k, v, causal, scale, bias, dropout_rate, dropout_seed,
                   window, window_symmetric, q.device.type == "cuda",
                   (block_q, block_k))


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              block_q=None, block_k=None, bias=None,
                              dropout_rate=0.0, dropout_seed=None,
                              window=None, window_symmetric=True):
    """`flash_attention` on the plain versions, on any device: the same
    arithmetic, the same dropout masks and the same autograd, with no
    kernel launched (the block sizes change nothing)."""
    return _attend(q, k, v, causal, scale, bias, dropout_rate, dropout_seed,
                   window, window_symmetric, False, (block_q, block_k))


def _attend(q, k, v, causal, scale, bias, dropout_rate, dropout_seed, window,
            window_symmetric, use_kernel, blocks):
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    b, h, lq = q.shape[0], q.shape[1], q.shape[2]
    g, lk = k.shape[1], k.shape[2]
    if v.shape[1] != g:
        raise ValueError(f"k has {g} heads but v has {v.shape[1]}")
    if g != h and (g == 0 or h % g):
        raise ValueError(f"query heads ({h}) must be a multiple of kv "
                         f"heads ({g})")
    if q.device.type not in ("cuda", "cpu"):
        raise MXNetError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if window is not None and int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    bias3, per_head, per_row = None, False, False
    if bias is not None:
        bias3, per_head, per_row = normalize_bias(bias, b, h, lq, lk)
        bias3 = bias3.to(q.device)
    rate = float(dropout_rate)
    seed = None
    if rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        seed = torch.as_tensor(dropout_seed).to(
            device=q.device, dtype=torch.int32).reshape(1)
    win = None if window is None else int(window)
    if g != h and per_head:
        # a per-head bias has no per-kv-head row to fold onto: expand K/V
        # to full heads and run ungrouped, as the JAX package does
        k = k.repeat_interleave(h // g, dim=1)
        v = v.repeat_interleave(h // g, dim=1)
        g = h
    if g == h:
        return _FlashAttention.apply(q, k, v, bias3, seed, s, bool(causal),
                                     rate, per_head, per_row, win,
                                     bool(window_symmetric), lq, use_kernel,
                                     blocks)
    rep = h // g
    # fold the query heads of a group onto the row axis: (b, h, lq, d) ->
    # (b, g, rep * lq, d); row r of a group is (head r // lq, pos r % lq)
    qf = q.reshape(b, g, rep * lq, d)
    out = _FlashAttention.apply(qf, k, v, bias3, seed, s, bool(causal), rate,
                                per_head, per_row, win,
                                bool(window_symmetric), lq, use_kernel,
                                blocks)
    return out.reshape(b, h, lq, d)


# ---------------------------------------------------------------------------
# autotune registration: the forward's tiles, as in the JAX package —
# `tune("flash_attention", (b, h, lq, lk, d), dtype)` times the forward at
# each candidate (block_q, block_k) and `resolve_blocks` picks the kept one
# up
# ---------------------------------------------------------------------------

def _at_shapes(shapes):
    return (list(shapes) + [1, 1, 256, 256, 64])[:5]


def _at_candidates(shapes, dtype):
    """The card's menu, block_q and block_k each 64 or 128, pruned by JAX's
    rule on Lq and Lk (a block neither dividing L nor within it), by a
    block's shared memory and, for heads over 64 wide, to 64 rows (see
    `_fwd_plan`); heads over 128 wide have one plan, so one candidate."""
    _, _, lq, lk, d = _at_shapes(shapes)
    dmax = _dmax(d)
    if dmax == 256:
        plan = _fwd_plan(1, 1, lq, lk, d, dtype, 64, 64)
        return [autotune.BlockConfig(block_q=plan.bq, block_k=plan.bk)]
    out = []
    for bq in FWD_TILES:
        if (lq % bq and bq > lq) or (bq > 64 and dmax > 64):
            continue
        for bk in FWD_TILES:
            if lk % bk and bk > lk:
                continue
            if _fwd_smem(dtype, dmax, bq, bk) > SMEM_BLOCK:
                continue
            out.append(autotune.BlockConfig(block_q=bq, block_k=bk))
    return out or [autotune.BlockConfig(block_q=64, block_k=64)]


def _at_roofline(config, shapes, dtype):
    """JAX's count (`mxnet_tpu/ops/pallas/flash_attention.py`
    `_at_roofline`): K and V stream once per q block."""
    b, h, lq, lk, d = _at_shapes(shapes)
    itemsize = 2 if _is_16bit(dtype) else 4
    bq, bk = config.block_q, config.block_k
    n_q = max(1, lq // max(1, bq))
    return {"flops": 4.0 * b * h * lq * lk * d,
            "bytes": b * h * itemsize * (2.0 * lq * d
                                         + n_q * 2.0 * lk * d),
            "steps": float(b * h * n_q * max(1, lk // max(1, bk)))}


def _at_inputs(shapes, dtype, device):
    """Seeded q, k and v of the shape, as the JAX package's `_at_build`
    makes them."""
    import numpy as np
    b, h, lq, lk, d = _at_shapes(shapes)
    rng = np.random.RandomState(0)
    dt = _torch_dtype(dtype)
    return tuple(torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32))
                 .to(device, dt) for n in (lq, lk, lk))


def _at_build(config, shapes, dtype):
    """The trial launch: the causal `flash_attention` forward at the
    candidate's blocks — the CUDA kernel on the card (it counts in
    `kernels.LAUNCHES`), the plain version on the CPU.  Returns the
    thunk."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    q, k, v = _at_inputs(shapes, dtype, dev)
    return lambda: flash_attention(q, k, v, causal=True,
                                   block_q=config.block_q,
                                   block_k=config.block_k)


autotune.register_tunable("flash_attention", _at_candidates, _at_build,
                          _at_roofline)
