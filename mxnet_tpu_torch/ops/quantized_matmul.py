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
"""
from __future__ import annotations

import ctypes
import torch

from ..base import MXNetError, getenv_bool
from .. import kernels as _kernels
from .policy import kernel_active

__all__ = ["QuantizedTensor", "quantize_weight", "dequantize_weight",
           "pack_int4", "unpack_int4", "quantized_matmul", "launches_kernel",
           "quantized_matmul_reference", "int8_act_matmul",
           "act_quant_enabled", "matmul_nt", "matmul_nt_reference",
           "gather_rows", "weight_nbytes"]


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
    ``in_features`` describe the planes."""

    def __init__(self, q, scale, bits: int, in_features: int):
        self.q = q              # int8 (out, in) or packed (out, ceil(in/2))
        self.scale = scale      # f32 (out,)
        self.bits = int(bits)
        self.in_features = int(in_features)

    @property
    def out_features(self) -> int:
        return int(self.q.shape[0])

    @property
    def shape(self):
        """Logical (dense) shape — what the f32 weight had."""
        return (self.out_features, self.in_features)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device),
                               self.bits, self.in_features)

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


def quantize_weight(w, bits: int = 8) -> QuantizedTensor:
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
    return QuantizedTensor(q, scale, bits, int(w.shape[1]))


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


def int8_act_matmul(x, qt: QuantizedTensor):
    """int8 activations x int8 weights (``MXTPU_QUANT_ACT``) — not ported
    yet; see ROADMAP.md queue C."""
    raise MXNetError(
        "int8_act_matmul (MXTPU_QUANT_ACT=1) is not ported to "
        "mxnet_tpu_torch yet (ROADMAP.md queue C); unset MXTPU_QUANT_ACT")


# ---------------------------------------------------------------------------
# K2: the CUDA kernel (csrc/quantized_matmul.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        f = _kernels.load("quantized_matmul").mxt_quantized_matmul
        f.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        f.restype = _I
        _fn = f
    return _fn


def _qmm_cuda(x2, qt: QuantizedTensor):
    """Check the operands, then launch K2 on the current stream."""
    M, K = x2.shape
    N = qt.out_features
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise MXNetError(f"quantized_matmul kernel takes float32 or "
                         f"bfloat16 activations, got {x2.dtype}")
    kp = (K + 1) // 2 if qt.bits == 4 else K
    if qt.q.dtype != torch.int8 or tuple(qt.q.shape) != (N, kp):
        raise MXNetError(
            f"int{qt.bits} planes must be int8 ({N}, {kp}); got "
            f"{qt.q.dtype} {tuple(qt.q.shape)}")
    if qt.scale.dtype != torch.float32 or tuple(qt.scale.shape) != (N,):
        raise MXNetError(f"scale must be float32 ({N},); got "
                         f"{qt.scale.dtype} {tuple(qt.scale.shape)}")
    for name, t in (("x", x2), ("q", qt.q), ("scale", qt.scale)):
        if t.device != x2.device:
            raise MXNetError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise MXNetError(f"quantized_matmul kernel needs a contiguous "
                             f"{name}")
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if out.numel() == 0:
        return out
    err = _kernel_fn()(
        x2.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(), out.data_ptr(),
        M, N, K, qt.bits, int(x2.dtype == torch.bfloat16),
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err:
        raise MXNetError(f"quantized_matmul kernel launch failed "
                         f"(cudaError_t {err})")
    _kernels.LAUNCHES["quantized_matmul"] += 1
    return out


# ---------------------------------------------------------------------------
# public dispatch
# ---------------------------------------------------------------------------

def launches_kernel(device) -> bool:
    """Does `quantized_matmul` on `device` launch K2?  On a card unless
    the policy says ``reference`` or ``off``; never on the CPU."""
    return device.type == "cuda" and kernel_active(device)


def quantized_matmul(x, qt: QuantizedTensor):
    """``x @ dequantize(qt).T`` with the dequant fused into the matmul.

    x: (..., in_features) float; returns (..., out_features) in x's dtype.
    Under the kernel policy (`ops.policy.kernel_active`, as the JAX
    ``kernel_eligible`` consults it) a CUDA tensor launches K2 (or raises);
    ``MXTPU_PALLAS=reference`` or ``off`` runs `quantized_matmul_reference`
    even on the card, and a CPU tensor always runs it.
    ``MXTPU_QUANT_ACT=1`` raises until the int8-activation path is
    ported."""
    if not isinstance(qt, QuantizedTensor):
        raise MXNetError("quantized_matmul needs a QuantizedTensor "
                         f"weight, got {type(qt).__name__}")
    if x.shape[-1] != qt.in_features:
        raise MXNetError(
            f"quantized_matmul: x last dim {x.shape[-1]} != weight "
            f"in_features {qt.in_features}")
    if act_quant_enabled():
        return int8_act_matmul(x, qt)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, qt.in_features)
    if x.device.type not in ("cuda", "cpu"):
        raise MXNetError(f"quantized_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    if launches_kernel(x.device):
        out = _qmm_cuda(x2.contiguous(), qt)
    else:
        out = quantized_matmul_reference(x2, qt)
    return out.reshape(*lead, qt.out_features)


def matmul_nt(x, w):
    """``x @ w.T`` for a dense tensor OR a `QuantizedTensor` — the one
    routing point of the decode core.  Dense products stay
    ``torch.matmul``."""
    if isinstance(w, QuantizedTensor):
        return quantized_matmul(x, w)
    return x @ w.T


def matmul_nt_reference(x, w):
    """`matmul_nt` through the plain version on any device — the oracle
    engine `chip_smoke.py` compares the kernel engine with."""
    if isinstance(w, QuantizedTensor):
        lead = x.shape[:-1]
        out = quantized_matmul_reference(x.reshape(-1, w.in_features), w)
        return out.reshape(*lead, w.out_features)
    return x @ w.T


def gather_rows(w, idx):
    """Row gather ``w[idx]`` with per-row dequantization for quantized
    weights (only the touched rows are dequantized)."""
    if not isinstance(w, QuantizedTensor):
        return w[idx]
    q = w.q[idx]
    if w.bits == 4:
        q = unpack_int4(q, w.in_features)
    return q.float() * w.scale[idx][..., None]
