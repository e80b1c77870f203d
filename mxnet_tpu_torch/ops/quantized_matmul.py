"""Weight-only int8/int4 dequant-matmul: CUDA kernel + plain torch.

Counterpart of ``mxnet_tpu/ops/pallas/quantized_matmul.py``.  Weights ship
as int8 (or int4, packed two per byte in int8 planes) with ONE symmetric
scale per output channel; the matmul dequantizes in registers, so the
weight is read from device memory at 1/4 (1/8) of its f32 width and never
materialised dense.

Layout: a quantized weight stands in for a dense ``(out, in)`` matrix
(the `Dense` / `attn_qkv` convention — forward is ``x @ w.T``):

- ``int8``: ``q`` is ``(out, in)`` int8, ``scale`` is ``(out,)`` f32,
  per-channel symmetric (``w ≈ q * scale[:, None]``).
- ``int4``: ``q`` is ``(out, ceil(in/2))`` int8; byte ``j`` packs value
  ``2j`` in its low nibble and ``2j+1`` in its high nibble (two's
  complement, the full ``[-8, 7]`` range round-trips; the quantizer
  itself stays symmetric in ``[-7, 7]``).  Odd ``in`` pads a zero value.

Dispatch: on a CUDA tensor `quantized_matmul` launches the hand-written
kernel ``csrc/quantized_matmul.cu`` (K2) or raises, unless ``MXTPU_PALLAS``
is ``reference`` or ``off`` (`ops.policy`); otherwise, and on a CPU tensor,
it runs `quantized_matmul_reference` (dequantize, then ``x @ w.T``) — the
plain version the CPU tests hold against the JAX package and
`chip_smoke.py` holds the kernel against on the card.

``MXTPU_QUANT_ACT=1`` (or ``act_quant=True``) quantizes the activations
too: `int8_act_matmul` rounds x to int8 at one symmetric scale a call (the
calibrated ``act_amax`` when the weight or the caller carries one, else
x's abs-max) and forms the exact int32 product of the int8 planes
(`int8_mm_nt`: ``torch._int_mm``, cuBLASLt's int8 path on the card — a
library product, as JAX leaves its ``lax.dot_general`` to XLA), then
scales in f32.  K2 is not launched on that route, as in JAX.

Launch plan: `_plan` (plain Python) picks K2's variant — the split-K
stream for M <= 16, the tensor-core tile kernel above — and its split-K
factor from the shape and the card's SM count; the autotuner's
``quantized_matmul`` tunable (`_candidates`, `_roofline`, `_build`, as in
the JAX package) can replace it.  The wrapper looks the plan up once per
(M, N, K, bits, dtype) and `autotune.generation()`.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, getenv_bool
from .. import kernels as _kernels
from . import autotune
from .policy import kernel_active

__all__ = ["QuantizedTensor", "quantize_weight", "dequantize_weight",
           "pack_int4", "unpack_int4", "quantized_matmul", "launches_kernel",
           "quantized_matmul_reference", "int8_act_matmul",
           "act_quant_enabled", "matmul_nt", "matmul_nt_reference",
           "gather_rows", "weight_nbytes", "int8_mm_nt"]


def act_quant_enabled() -> bool:
    """``MXTPU_QUANT_ACT=1``: int8 activations for quantized matmuls."""
    return getenv_bool("MXTPU_QUANT_ACT", False)


# ---------------------------------------------------------------------------
# int4 packing
# ---------------------------------------------------------------------------

def pack_int4(q):
    """Pack int4 values (int8-held, each in [-8, 7]) two per byte along
    the last axis: byte ``j`` = value ``2j`` (low nibble) | value ``2j+1``
    (high nibble).  An odd trailing dim pads a zero value; callers record
    the logical length (`QuantizedTensor.in_features`)."""
    q = torch.as_tensor(q).to(torch.int8)
    if q.shape[-1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    lo = q[..., 0::2]
    hi = q[..., 1::2]
    # two's-complement nibbles: mask the low, shift the high; int8 '<<'
    # keeps the byte width
    return (lo & 0x0F) | (hi << 4)


def unpack_int4(packed, k: int):
    """Inverse of :func:`pack_int4` -> int8 values in [-8, 7], sliced back
    to the logical last-dim length `k`."""
    b = torch.as_tensor(packed).to(torch.int8)
    # arithmetic shifts on int8 sign-extend: (b << 4) >> 4 recovers the
    # signed low nibble, b >> 4 the signed high nibble
    lo = (b << 4) >> 4
    hi = b >> 4
    out = torch.stack([lo, hi], dim=-1).reshape(
        *b.shape[:-1], 2 * b.shape[-1])
    return out[..., :k]


# ---------------------------------------------------------------------------
# QuantizedTensor
# ---------------------------------------------------------------------------

class QuantizedTensor:
    """A per-channel symmetrically quantized ``(out, in)`` weight: int8
    planes ``q`` (packed for int4) and f32 ``scale`` (out,).  ``bits`` and
    ``in_features`` describe the planes; ``act_amax`` is an optional
    calibrated activation threshold (a float) that the int8-activation
    path uses instead of a dynamic abs-max a call."""

    def __init__(self, q, scale, bits: int, in_features: int,
                 act_amax: Optional[float] = None):
        self.q = q              # int8 (out, in) or packed (out, ceil(in/2))
        self.scale = scale      # f32 (out,)
        self.bits = int(bits)
        self.in_features = int(in_features)
        self.act_amax = act_amax
        self._checked = None    # (q, scale) once K2's wrapper checked them
        self._rhs = None        # (q, int8 planes for `int8_mm_nt`)

    @property
    def out_features(self) -> int:
        return int(self.q.shape[0])

    @property
    def shape(self):
        """Logical (dense) shape — what the f32 weight had."""
        return (self.out_features, self.in_features)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device),
                               self.bits, self.in_features, self.act_amax)

    def nbytes(self) -> int:
        return weight_nbytes(self)

    def __repr__(self):
        return (f"QuantizedTensor(int{self.bits}, {self.shape}, "
                f"planes {tuple(self.q.shape)})")


def weight_nbytes(w) -> int:
    """Stored bytes of a weight leaf (quantized planes + scales, or the
    dense tensor)."""
    if isinstance(w, QuantizedTensor):
        return (w.q.numel() * w.q.element_size()
                + w.scale.numel() * w.scale.element_size())
    return w.numel() * w.element_size()


def quantize_weight(w, bits: int = 8,
                    act_amax: Optional[float] = None) -> QuantizedTensor:
    """Per-channel symmetric quantization of a dense ``(out, in)`` weight.
    ``scale[n] = amax(w[n, :]) / qmax`` with qmax 127 (int8) or 7 (int4);
    an all-zero channel gets scale 0 and dequantizes to exact zeros.
    Rounds half to even (``torch.round``, as ``jnp.round`` does), so it
    gives the JAX package's planes bit for bit."""
    if bits not in (4, 8):
        raise MXNetError(f"quantize_weight supports bits in (4, 8), "
                         f"got {bits}")
    w = torch.as_tensor(w)
    if w.dim() != 2:
        raise MXNetError(f"quantize_weight expects a 2-D (out, in) "
                         f"weight, got shape {tuple(w.shape)}")
    qmax = 127.0 if bits == 8 else 7.0
    wf = w.float()
    amax = wf.abs().amax(dim=1)                               # (out,)
    scale = amax / qmax
    inv = torch.where(scale > 0.0, 1.0 / torch.clamp(scale, min=1e-30),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(wf * inv[:, None]), -qmax, qmax).to(
        torch.int8)
    if bits == 4:
        q = pack_int4(q)
    return QuantizedTensor(q, scale, bits, int(w.shape[1]),
                           act_amax=act_amax)


def dequantize_weight(qt: QuantizedTensor, dtype=torch.float32):
    """Dense ``(out, in)`` reconstruction — the plain version's weight."""
    q = qt.q
    if qt.bits == 4:
        q = unpack_int4(q, qt.in_features)
    return (q.float() * qt.scale[:, None]).to(dtype)


# ---------------------------------------------------------------------------
# the plain version of K2
# ---------------------------------------------------------------------------

def quantized_matmul_reference(x, qt: QuantizedTensor):
    """Dequantize-then-matmul: ``x @ deq(qt).T`` in f32, cast back to x's
    dtype.  It materialises the dense f32 weight — exactly what K2 avoids."""
    w = dequantize_weight(qt, torch.float32)
    return (x.float() @ w.T).to(x.dtype)


def _pad_to(t, rows: int, cols: int):
    r, c = t.shape
    return t if (r, c) == (rows, cols) else F.pad(t, (0, cols - c,
                                                      0, rows - r))


def int8_mm_nt(a, b):
    """``a @ b.T`` -> int32 for int8 ``a`` (M, K) and ``b`` (N, K), exact.

    ``torch._int_mm``: on the card cuBLASLt's int8 product, which refuses
    M <= 16 and a K or N that is not a multiple of 8 (8 decode slots; a
    tied head of 50257 rows), so there the operands are padded with zeros
    to shapes it takes and the product sliced back — zeros add nothing to
    an integer sum, so the card's and the CPU's sums are bit-equal.  ``b``
    may already carry such zero rows and columns (`_rhs_planes`); the
    result then has them too, sliced by the caller."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b.t())
    return _int_mm_padded(a, b)


def _int_mm_padded(a, b):
    """`int8_mm_nt` over operands zero-padded to what the card's
    ``torch._int_mm`` takes: more than 16 rows, K and N multiples of 8."""
    M, K = a.shape
    N, Kb = b.shape
    Kp = -(-max(K, Kb) // 8) * 8
    Mp = 32 if M <= 16 else M
    return torch._int_mm(_pad_to(a, Mp, Kp), _pad_to(b, -(-N // 8) * 8,
                                                     Kp).t())[:M, :N]


def _rhs_planes(qt: QuantizedTensor):
    """qt's int8 values (N, K) — int4 planes unpacked — as `int8_mm_nt`'s
    right operand, zero-padded on the card to multiples of 8; kept on `qt`
    (a serving step uses each weight once a layer, every step)."""
    got = qt._rhs
    if got is not None and got[0] is qt.q:
        return got[1]
    q = qt.q if qt.bits == 8 else unpack_int4(qt.q, qt.in_features)
    if q.device.type == "cuda":
        q = _pad_to(q, -(-q.shape[0] // 8) * 8,
                    -(-q.shape[1] // 8) * 8).contiguous()
    qt._rhs = (qt.q, q)
    return q


def int8_act_matmul(x, qt: QuantizedTensor, act_amax=None):
    """int8 activations x int8 weights -> int32, with an f32 dequant
    epilogue (``MXTPU_QUANT_ACT``; `contrib.quantization` parity widened
    to per-channel weight scales), in the JAX package's order: x's scale
    ``amax / 127`` from ``act_amax``, else the threshold riding on `qt`,
    else x's abs-max this call; ``xq = clip(round(x / scale))`` (half to
    even); the exact int32 product (`int8_mm_nt`); then ``acc * x_scale *
    qt.scale`` in f32, cast to x's dtype.  A calibrated threshold is
    taken in f32 on the host (numpy's float32 rounds as JAX's does), so a
    step makes no host-to-device copy for it."""
    xq, x_scale = _quantize_act(x, qt, act_amax)
    N = qt.out_features
    acc = int8_mm_nt(xq.reshape(-1, qt.in_features), _rhs_planes(qt))[:, :N]
    out = acc.float() * x_scale * qt.scale
    return out.to(x.dtype).reshape(*x.shape[:-1], N)


def _quantize_act(x, qt: QuantizedTensor, act_amax=None):
    """`int8_act_matmul`'s first half: ``(xq int8, x_scale)``, the scale a
    0-d tensor (dynamic) or a float (calibrated)."""
    xf = x.float()
    if act_amax is None:
        act_amax = qt.act_amax
    if act_amax is None:
        x_scale = xf.abs().amax() / 127.0
        inv = torch.where(x_scale > 0.0,
                          1.0 / torch.clamp(x_scale, min=1e-30), 0.0)
    else:
        s32 = np.float32(act_amax) / np.float32(127.0)
        x_scale = float(s32)
        inv = float(np.float32(1.0) / max(s32, np.float32(1e-30))) \
            if s32 > 0 else 0.0
    return torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8), \
        x_scale


class _ActQuant(torch.autograd.Function):
    """`int8_act_matmul` forward; the backward is dx against the
    dequantized weight, as the JAX package's ``custom_vjp`` gives it (the
    rounding has no useful derivative, the weight is frozen)."""

    @staticmethod
    def forward(ctx, x, qt, act_amax):
        ctx.qt = qt
        return int8_act_matmul(x, qt, act_amax)

    @staticmethod
    def backward(ctx, dy):
        w = dequantize_weight(ctx.qt, torch.float32)
        return (dy.float() @ w).to(dy.dtype), None, None


def _act_quant_matmul(x, qt: QuantizedTensor, act_amax=None):
    if torch.is_grad_enabled() and x.requires_grad:
        return _ActQuant.apply(x, qt, act_amax)
    return int8_act_matmul(x, qt, act_amax)


# ---------------------------------------------------------------------------
# K2: the CUDA kernel (csrc/quantized_matmul.cu) and its launch plan
# ---------------------------------------------------------------------------

SMALL_M = 16            # M up to this takes the streaming variant
SMALL_ROWS = 8          # output channels a block of the small variant owns
SMALL_LANES = 16        # lanes that walk one weight row, 16 bytes each
LARGE_TILE = (64, 64, 32)   # the tile kernel's (BM, BN, BK)
SMALL_SMEM = 40 * 1024  # bytes of the small variant's staged x chunk
VARIANTS = ("small", "large")


class Plan(NamedTuple):
    """One K2 launch: the variant, its tile, the split-K factor and the K
    values each split covers, and what the wrapper allocates for it."""
    variant: str         # "small" (streaming, M <= 16) or "large" (tiles)
    tile: Tuple[int, ...]   # small: (channels, lanes a row); large: BM, BN, BK
    split: int           # blocks along K; partials reduced in split order
    kc: int              # K values a split covers
    blocks: int          # the grid's blocks
    tiles: int           # output tiles: one ticket counter each
    workspace: int       # f32 partials (split * M * N), 0 with one split


def _granule(variant: str, bits: int) -> int:
    """The K values a split must be a multiple of: one 16-byte load for
    each of a row's lanes (small), one K step (large)."""
    if variant == "small":
        return SMALL_LANES * (16 if bits == 8 else 32)
    return LARGE_TILE[2]


def _plan(M: int, N: int, K: int, bits: int, dtype, sm_count: int,
          variant: Optional[str] = None, split: Optional[int] = None) -> Plan:
    """The launch plan of one K2 call, plain Python (no card needed).

    The small variant for M <= 16, else the tile kernel (``variant``
    overrides, as the autotuner's candidates do).  The split-K factor
    (``split`` overrides) grows until the grid holds two blocks per SM
    and no lane loads more than three 16-byte vectors (small), or until
    the tiles fill one wave and no split runs more than 12 K steps
    (large; no split where the tiles fill two waves), as far as K's
    granules allow.  Each split covers a whole number of granules, the
    last one what is left; the small variant's staged x chunk caps a
    split at 40 KB.  ``dtype`` (x's) does not change the plan: both
    dtypes share the tiles."""
    del dtype
    variant = variant or ("small" if M <= SMALL_M else "large")
    if variant not in VARIANTS:
        raise MXNetError(f"unknown K2 variant {variant!r}")
    if variant == "small" and M > SMALL_M:
        raise MXNetError(f"the small K2 variant takes M <= {SMALL_M}, "
                         f"got {M}")
    g = _granule(variant, bits)
    ngran = max(1, -(-K // g))
    if variant == "small":
        tile = (SMALL_ROWS, SMALL_LANES)
        tiles = -(-N // SMALL_ROWS)
        mt = 8 if M <= 8 else 16
        kc_max = max(g, SMALL_SMEM // (4 * mt) // g * g)
        # two blocks an SM, and at most three loads a lane in a split
        want = max(-(-2 * sm_count // tiles), -(-ngran // 3))
    else:
        tile = LARGE_TILE
        tiles = -(-M // LARGE_TILE[0]) * -(-N // LARGE_TILE[1])
        kc_max = ngran * g
        # one wave of tiles, and at most 12 K steps a split, unless the
        # tiles alone fill two waves
        want = 1 if tiles >= 2 * sm_count else max(
            -(-sm_count // tiles), -(-ngran // 12))
    if split is None:
        split = want
    split = max(1, min(int(split), ngran))
    kc = min(ngran // split * g, kc_max)
    split = max(1, -(-K // kc))
    return Plan(variant, tile, split, kc, tiles * split, tiles,
                split * M * N if split > 1 else 0)


_P = ctypes.c_void_p
_I = ctypes.c_int
_fn = None
# the C entry's x dtype codes (ops/fused_norm.py's numbering); the output
# takes x's dtype
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# (device index, raw stream) -> (ticket counters, f32 partials workspace)
_scratch_of: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}
# plans already made, keyed by shape, bits, dtype and device, valid for the
# autotuner generation in `_plan_memo_gen`
_plan_memo: Dict[Any, Plan] = {}
_plan_memo_gen = None


def _kernel_fn():
    global _fn
    if _fn is None:
        f = _kernels.load("quantized_matmul").mxt_quantized_matmul
        f.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                      _P]
        f.restype = _I
        _fn = f
    return _fn


_sms = _kernels.sm_count   # the card's SM count, read once per device


def _tuned_plan(M, N, K, bits, dtype, device) -> Plan:
    """`_plan` under the autotuner's choice for (M, N, K), ``int<bits>``
    and x's dtype, looked up once per key and `autotune.generation()`,
    not at each of a step's calls."""
    global _plan_memo_gen
    gen = autotune.generation()
    if gen != _plan_memo_gen:
        _plan_memo.clear()
        _plan_memo_gen = gen
    key = (M, N, K, bits, dtype, device)
    plan = _plan_memo.get(key)
    if plan is None:
        cfg = autotune.cached_config("quantized_matmul", (M, N, K),
                                     _tune_dtype(bits, dtype))
        variant = split = None
        if cfg is not None and "variant" in cfg and "split" in cfg:
            # a bucket holds M <= 16 or M > 16 alone, so a tuned variant
            # always fits the M it is looked up for
            variant, split = VARIANTS[cfg.variant], cfg.split
        plan = _plan_memo[key] = _plan(M, N, K, bits, dtype, _sms(device),
                                       variant, split)
    return plan


def _check_weight(qt: QuantizedTensor):
    """The planes' and scales' dtype, shape, device and layout, checked
    once per pair of tensors: the serving step reuses one weight 48 times
    a step, and the wrapper's host time is what a host-bound step pays."""
    if qt._checked is not None and qt._checked[0] is qt.q \
            and qt._checked[1] is qt.scale:
        return
    N, K = qt.out_features, qt.in_features
    kp = (K + 1) // 2 if qt.bits == 4 else K
    if qt.q.dtype != torch.int8 or tuple(qt.q.shape) != (N, kp):
        raise MXNetError(
            f"int{qt.bits} planes must be int8 ({N}, {kp}); got "
            f"{qt.q.dtype} {tuple(qt.q.shape)}")
    if qt.scale.dtype != torch.float32 or tuple(qt.scale.shape) != (N,):
        raise MXNetError(f"scale must be float32 ({N},); got "
                         f"{qt.scale.dtype} {tuple(qt.scale.shape)}")
    if qt.scale.device != qt.q.device:
        raise MXNetError(f"scale is on {qt.scale.device}, q on "
                         f"{qt.q.device}")
    for name, t in (("q", qt.q), ("scale", qt.scale)):
        if not t.is_contiguous():
            raise MXNetError(f"quantized_matmul kernel needs a contiguous "
                             f"{name}")
    qt._checked = (qt.q, qt.scale)


def _qmm_cuda(x2, qt: QuantizedTensor, plan: Optional[Plan] = None):
    """Check the operands, then launch K2 on the current stream with
    `plan` (default: the tuned or planned one for this shape)."""
    M, K = x2.shape
    N = qt.out_features
    dt = x2.dtype
    if dt not in _X_DTYPES:
        raise MXNetError(f"quantized_matmul kernel takes float32, bfloat16 "
                         f"or float16 activations, got {dt}")
    _check_weight(qt)
    dev = x2.device
    if qt.q.device != dev:
        raise MXNetError(f"q is on {qt.q.device}, x on {dev}")
    if not x2.is_contiguous():
        raise MXNetError("quantized_matmul kernel needs a contiguous x")
    out = torch.empty((M, N), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = _tuned_plan(M, N, K, qt.bits, dt, dev)
    # the raw handle, without building a torch.cuda.Stream each call
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ws = cnt = None
    if plan.split > 1:
        cnt, ws = _kernels.stream_scratch(_scratch_of, dev, stream,
                                          plan.tiles, plan.workspace)
        cnt, ws = cnt.data_ptr(), ws.data_ptr()
    err = _kernel_fn()(
        x2.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(), out.data_ptr(),
        M, N, K, qt.bits, _X_DTYPES[dt],
        plan.variant == "large", plan.kc, ws, cnt, stream)
    if err:
        raise MXNetError(f"quantized_matmul kernel launch failed "
                         f"(cudaError_t {err}, {plan})")
    _kernels.count_launch("quantized_matmul", dt)
    return out


# ---------------------------------------------------------------------------
# public dispatch
# ---------------------------------------------------------------------------

def launches_kernel(device) -> bool:
    """Does `quantized_matmul` on `device` launch K2?  On a card unless
    the policy says ``reference`` or ``off``; never on the CPU."""
    return device.type == "cuda" and kernel_active(device)


def quantized_matmul(x, qt: QuantizedTensor, act_amax=None,
                     act_quant: Optional[bool] = None):
    """``x @ dequantize(qt).T`` with the dequant fused into the matmul.

    x: (..., in_features) float; returns (..., out_features) in x's dtype.
    Under the kernel policy (`ops.policy.kernel_active`, as the JAX
    ``kernel_eligible`` consults it) a CUDA tensor launches K2 (or raises);
    ``MXTPU_PALLAS=reference`` or ``off`` runs `quantized_matmul_reference`
    even on the card, and a CPU tensor always runs it.  ``act_quant``
    (default: ``MXTPU_QUANT_ACT``, read each call) takes the int8-activation
    route instead, `int8_act_matmul` at ``act_amax`` (or the weight's
    threshold, or a dynamic abs-max), and launches no K2, as the JAX
    package's ``use_kernel = kernel_eligible(x) and not act_quant`` has it;
    its backward is dx against the dequantized weight."""
    if not isinstance(qt, QuantizedTensor):
        raise MXNetError("quantized_matmul needs a QuantizedTensor "
                         f"weight, got {type(qt).__name__}")
    if x.shape[-1] != qt.in_features:
        raise MXNetError(
            f"quantized_matmul: x last dim {x.shape[-1]} != weight "
            f"in_features {qt.in_features}")
    if act_quant is None:
        act_quant = act_quant_enabled()
    if act_quant:
        return _act_quant_matmul(x, qt, act_amax)
    dev = x.device
    if dev.type not in ("cuda", "cpu"):
        raise MXNetError(f"quantized_matmul runs on cuda or cpu, not {dev}")
    flat = x.dim() != 2
    x2 = x.reshape(-1, qt.in_features) if flat else x
    if launches_kernel(dev):
        out = _qmm_cuda(x2.contiguous(), qt)
    else:
        out = quantized_matmul_reference(x2, qt)
    return out.reshape(*x.shape[:-1], qt.out_features) if flat else out


def _dense_nt(x, w):
    """``x @ w.T`` in the promoted dtype of the operands, as ``jnp.matmul``
    promotes (f32 activations after an f32 LayerNorm gain meet bf16
    weights in a bf16 model's decode step)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt).T


def matmul_nt(x, w, act_amax=None):
    """``x @ w.T`` for a dense tensor OR a `QuantizedTensor` — the one
    routing point of the decode core.  Dense products stay
    ``torch.matmul``, in the promoted dtype."""
    if isinstance(w, QuantizedTensor):
        return quantized_matmul(x, w, act_amax=act_amax)
    return _dense_nt(x, w)


def matmul_nt_reference(x, w, act_amax=None):
    """`matmul_nt` through the plain version on any device — the oracle
    engine `chip_smoke.py` compares the kernel engine with.  Under
    ``MXTPU_QUANT_ACT`` both take `int8_act_matmul`, which launches no
    kernel of the port."""
    if isinstance(w, QuantizedTensor):
        if act_quant_enabled():
            return _act_quant_matmul(x, w, act_amax)
        lead = x.shape[:-1]
        out = quantized_matmul_reference(x.reshape(-1, w.in_features), w)
        return out.reshape(*lead, w.out_features)
    return _dense_nt(x, w)


def gather_rows(w, idx):
    """Row gather ``w[idx]`` with per-row dequantization for quantized
    weights (only the touched rows are dequantized)."""
    if not isinstance(w, QuantizedTensor):
        return w[idx]
    q = w.q[idx]
    if w.bits == 4:
        q = unpack_int4(q, w.in_features)
    return q.float() * w.scale[idx][..., None]


# ---------------------------------------------------------------------------
# autotune registration: K2's plan menu (variant x split-K factor)
# ---------------------------------------------------------------------------

_TUNE_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def _tune_dtype(bits: int, dtype) -> str:
    """The tuner key's dtype: ``int8`` / ``int4`` for f32 activations, as
    the JAX package keys it, with ``_bfloat16`` or ``_float16`` appended
    for 16-bit ones (they take other instructions in the tile kernel)."""
    name = autotune.dtype_name(dtype)
    return f"int{bits}" if name == "float32" else f"int{bits}_{name}"


def _bits_of(dtype) -> int:
    return 4 if str(dtype).startswith("int4") else 8


def _x_dtype(dtype):
    """The activations' dtype a tuner key names (`_tune_dtype` read
    back): ``int8_bfloat16`` -> bf16, ``int8_float16`` -> f16, a bare
    ``int8`` / ``int4`` -> f32."""
    name = str(dtype)
    for suffix, dt in (("_bfloat16", torch.bfloat16),
                       ("_float16", torch.float16)):
        if name.endswith(suffix):
            return dt
    return torch.float32


def _shape3(shapes):
    m = shapes[0] if shapes else 256
    n = shapes[1] if len(shapes) > 1 else 1024
    k = shapes[2] if len(shapes) > 2 else 1024
    return int(m), int(n), int(k)


def _candidates(shapes, dtype):
    """Every distinct plan of the menu: the small variant (M <= 16) and the
    tile kernel, each at the split factors K's granules allow."""
    m, n, k = _shape3(shapes)
    bits = _bits_of(dtype)
    out, seen = [], set()
    for vi, variant in enumerate(VARIANTS):
        if variant == "small" and m > SMALL_M:
            continue
        for s in _TUNE_SPLITS:
            p = _plan(m, n, k, bits, None, 132, variant, s)
            if (vi, p.split) not in seen:
                seen.add((vi, p.split))
                out.append(autotune.BlockConfig(variant=vi, split=p.split))
    return out


def _roofline(config, shapes, dtype):
    """JAX's count (`mxnet_tpu/ops/pallas/quantized_matmul.py` `_roofline`):
    x read at 4 bytes, the weight at bits / 8 plus f32 scales, the output at
    4; one step per block of the plan."""
    m, n, k = _shape3(shapes)
    bits = _bits_of(dtype)
    p = _plan(m, n, k, bits, None, 132, VARIANTS[config.variant],
              config.split)
    return {"flops": 2.0 * m * n * k,
            "bytes": m * k * 4.0 + n * k * bits / 8.0 + n * 4.0
            + m * n * 4.0,
            "steps": float(p.blocks)}


def _build(config, shapes, dtype):
    """The trial launch: K2 over seeded (M, K) activations and a seeded
    quantized (N, K) weight at the candidate's plan — the CUDA kernel on
    the card (it counts in `kernels.LAUNCHES`), the plain version on the
    CPU.  Returns the thunk."""
    m, n, k = _shape3(shapes)
    bits = _bits_of(dtype)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(m, k, generator=gen).to(dev, _x_dtype(dtype))
    qt = quantize_weight(torch.randn(n, k, generator=gen) * 0.02,
                         bits).to(dev)
    if dev.type == "cpu":
        return lambda: quantized_matmul_reference(x, qt)
    plan = _plan(m, n, k, bits, x.dtype, _sms(dev),
                 VARIANTS[config.variant], config.split)
    return lambda: _qmm_cuda(x, qt, plan)


autotune.register_tunable("quantized_matmul", _candidates, _build, _roofline)
