"""Streaming sparse-label softmax cross-entropy: CUDA kernel + plain torch.

Counterpart of ``mxnet_tpu/ops/pallas/softmax_xent.py``: the per-row loss
``lse_i - x_i,label_i`` over (…, V) logits, whose backward is
``dx = (softmax(x) - onehot(label)) * g`` in x's dtype (f32, bf16 or
f16; in f16 a gradient past the range is +-inf, as JAX's cast gives it).  The kernel streams
the logits once and keeps only per-row (max, sum-exp) statistics, so the
f32 (N, V) log-probabilities a ``log_softmax`` route would write never
exist; the backward recomputes softmax from the saved f32 lse.

- On a CUDA tensor `softmax_cross_entropy` launches the hand-written
  kernels of ``csrc/softmax_xent.cu`` (any V, including 30522, which has
  no power-of-two divisor), or raises on what they do not take.
- On a CPU tensor it runs `xent_fwd_reference` / `xent_bwd_reference`,
  the plain versions the CPU tests hold against the JAX package.
- `softmax_cross_entropy_reference` runs those plain versions under the
  same autograd on any device, by name: the oracle a run on the card is
  held against.

Labels are not clamped, as in JAX: a label outside [0, V) matches no
column, so its loss is the row's lse and its one-hot row is zero.

The forward kernel's launch is planned here in plain Python and checked on
the CPU: `_fwd_plan` (persistent blocks over the rows, at most one
resident wave) and `_row_split` (a row's scalar head, 16-byte body and
scalar tail at its start address's phase), which the kernel's
``row_split`` mirrors.  JAX's ``MXTPU_XENT_BLOCK_N`` / ``_V`` tile knobs
are not read: the card's plan has no tile to choose.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..base import MXNetError
from .. import kernels as _kernels

__all__ = ["softmax_cross_entropy", "softmax_cross_entropy_reference",
           "xent_fwd_reference", "xent_bwd_reference"]


def _hit(lab, V):
    """(N,) label -> (valid, clamped index) for a gather that never reads
    out of range."""
    valid = (lab >= 0) & (lab < V)
    return valid, torch.where(valid, lab, 0).long()


def xent_fwd_reference(x, labels):
    """Plain version of the forward kernel over (N, V) logits: returns
    (loss, lse), both (N,) f32."""
    xf = x.float()
    lse = torch.logsumexp(xf, dim=-1)
    valid, idx = _hit(labels, x.shape[-1])
    t = torch.where(valid, xf.gather(-1, idx[:, None])[:, 0], 0.0)
    return lse - t, lse


def xent_bwd_reference(x, labels, lse, g):
    """Plain version of the backward kernel: dx (N, V) in x's dtype."""
    p = torch.exp(x.float() - lse[:, None])
    valid, idx = _hit(labels, x.shape[-1])
    onehot = torch.zeros_like(p).scatter_(-1, idx[:, None],
                                          valid[:, None].float())
    return ((p - onehot) * g.float()[:, None]).to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/softmax_xent.cu)
# ---------------------------------------------------------------------------

# the forward kernel's constants (csrc/softmax_xent.cu)
FWD_THREADS = 256     # threads a block
FWD_MIN_BLOCKS = 4    # resident blocks an SM (__launch_bounds__)
FWD_UNROLL = 4        # 16-byte vectors a thread a batch


class FwdPlan(NamedTuple):
    """One launch of the forward kernel."""
    grid: int           # persistent blocks; block b takes rows b, b + grid..
    rounds: int         # rows a block takes, at most


@functools.lru_cache(maxsize=None)
def _fwd_plan(N: int, sm_count: int) -> FwdPlan:
    """The forward's launch for N rows, plain Python: the fewest rounds of
    rows one resident wave (`FWD_MIN_BLOCKS` blocks an SM) allows, and as
    many blocks as spread the rows evenly over them, so each block takes
    `rounds` rows or one fewer."""
    rounds = max(1, -(-N // (sm_count * FWD_MIN_BLOCKS)))
    return FwdPlan(max(1, -(-N // rounds)), rounds)


def _row_split(V: int, itemsize: int, phase: int):
    """(head, vectors, tail) of a row of V elements that starts `phase`
    bytes past a 16-byte boundary: scalars up to the boundary (at most V),
    whole 16-byte vectors, then the scalars left (the kernel's
    ``row_split``)."""
    per = 16 // itemsize
    head = min(V, ((16 - phase) % 16) // itemsize)
    nvec = (V - head) // per
    return head, nvec, V - head - nvec * per


_P = ctypes.c_void_p
_I = ctypes.c_int
# the logits' types and their codes (the C entry points' `dtype`)
_XDTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fns = {}


def _kernel_fn(direction):
    f = _fns.get(direction)
    if f is None:
        f = getattr(_kernels.load("softmax_xent"),
                    f"mxt_softmax_xent_{direction}")
        f.argtypes = [_P] * 4 + [_I] * 4 + [_P] if direction == "fwd" \
            else [_P] * 5 + [_I] * 3 + [_P]
        f.restype = _I
        _fns[direction] = f
    return f


def _check(x, labels):
    # one test for the common case; the tests below name what is wrong
    if (x.dtype in _XDTYPES and labels.dtype == torch.int32 and
            labels.shape == x.shape[:1] and x.shape[0] < 2 ** 31 and
            x.shape[1] < 2 ** 31 and labels.device == x.device and
            x.is_contiguous() and labels.is_contiguous()):
        return
    if x.dtype not in _XDTYPES:
        raise MXNetError(f"softmax_cross_entropy kernel takes float32, "
                         f"bfloat16 or float16 logits, got {x.dtype}")
    if labels.dtype != torch.int32 or tuple(labels.shape) != (x.shape[0],):
        raise MXNetError(f"labels must be int32 ({x.shape[0]},); got "
                         f"{labels.dtype} {tuple(labels.shape)}")
    if max(x.shape) >= 2 ** 31:
        raise MXNetError(f"softmax_cross_entropy kernel takes N, V < 2**31; "
                         f"got {tuple(x.shape)}")
    for name, t in (("logits", x), ("labels", labels)):
        if t.device != x.device:
            raise MXNetError(f"{name} is on {t.device}, logits on {x.device}")
        if not t.is_contiguous():
            raise MXNetError(f"softmax_cross_entropy kernel needs contiguous "
                             f"{name}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _xent_fwd_cuda(x, labels):
    """Check the operands, then launch the forward kernel on the current
    stream; returns (loss, lse), both (N,) f32."""
    _check(x, labels)
    N, V = x.shape
    dev = x.device
    loss = torch.empty(N, dtype=torch.float32, device=dev)
    lse = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0:
        return loss, lse
    plan = _fwd_plan(N, _kernels.sm_count(dev))
    err = _kernel_fn("fwd")(x.data_ptr(), labels.data_ptr(), loss.data_ptr(),
                            lse.data_ptr(), N, V, _XDTYPES[x.dtype],
                            plan.grid,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise MXNetError(f"softmax_cross_entropy forward kernel launch "
                         f"failed (cudaError_t {err})")
    _kernels.count_launch("softmax_xent_fwd", x.dtype)
    return loss, lse


def _xent_bwd_cuda(x, labels, lse, g):
    """Check the operands, then launch the backward kernel; returns dx."""
    _check(x, labels)
    N, V = x.shape
    for name, t in (("lse", lse), ("g", g)):
        if t.dtype != torch.float32 or tuple(t.shape) != (N,) or \
                not t.is_contiguous() or t.device != x.device:
            raise MXNetError(f"{name} must be contiguous f32 ({N},) on "
                             f"{x.device}")
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    err = _kernel_fn("bwd")(x.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                            g.data_ptr(), dx.data_ptr(), N, V,
                            _XDTYPES[x.dtype], _stream(x))
    if err:
        raise MXNetError(f"softmax_cross_entropy backward kernel launch "
                         f"failed (cudaError_t {err})")
    _kernels.count_launch("softmax_xent_bwd", x.dtype)
    return dx


class _SoftmaxXent(torch.autograd.Function):
    """Saves the logits, labels and f32 lse (``_xent`` and its custom VJP
    in the JAX package); labels get no gradient."""

    @staticmethod
    def forward(ctx, x, labels, use_kernel):
        if use_kernel:
            loss, lse = _xent_fwd_cuda(x, labels)
        else:
            loss, lse = xent_fwd_reference(x, labels)
        ctx.save_for_backward(x, labels, lse)
        ctx.use_kernel = use_kernel
        return loss

    @staticmethod
    def backward(ctx, g):
        x, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if ctx.use_kernel:
            dx = _xent_bwd_cuda(x, labels, lse, g)
        else:
            dx = xent_bwd_reference(x, labels, lse, g)
        return dx, None, None


def softmax_cross_entropy(logits, labels, block_n=None, block_v=None):
    """Per-row sparse-label cross entropy over (…, V) logits -> loss of the
    labels' shape (f32).  Leading dims are flattened.  A CUDA tensor
    launches the kernels; a CPU tensor runs the plain versions.
    ``block_n`` / ``block_v`` are the JAX kernel's tile sizes; they are
    accepted and ignored: the card's plan (`_fwd_plan`) has no tile to
    set."""
    return _xent(logits, labels, logits.device.type == "cuda")


def softmax_cross_entropy_reference(logits, labels):
    """`softmax_cross_entropy` on the plain versions, on any device, with
    no kernel launched."""
    return _xent(logits, labels, False)


def _xent(logits, labels, use_kernel):
    shape = logits.shape
    V = shape[-1]
    if logits.device.type not in ("cuda", "cpu"):
        raise MXNetError(f"softmax_cross_entropy runs on cuda or cpu, not "
                         f"{logits.device}")
    x = logits.reshape(-1, V)
    lab = torch.as_tensor(labels, device=logits.device).reshape(-1)
    if use_kernel:
        x = x.contiguous()
        lab = lab.to(torch.int32).contiguous()
    return _SoftmaxXent.apply(x, lab, use_kernel).reshape(shape[:-1])
