"""Fused LayerNorm / RMSNorm (+ residual add): CUDA row kernel + plain torch.

Counterpart of ``mxnet_tpu/ops/pallas/fused_norm.py``.  One row kernel
covers the normalisation surface of the transformers:

- `fused_layer_norm` (x, gamma, beta) and `fused_rms_norm` (x, gamma) over
  the last axis;
- `layer_norm_residual` / `rms_norm_residual`: ``s = residual + x; y =
  norm(s)`` in one pass, returning ``(y, s)``.

Two routes, as in the JAX package:

- the **reference route** (`layer_norm_reference`, `rms_norm_reference`):
  the math of ``npx.layer_norm`` in the input's dtype, promoted against
  the parameters' (bf16 x with f32 gamma gives f32);
- the **kernel route**: statistics in f32 (two-pass mean, then centred
  variance; ``rsqrt``), ``y`` and ``s`` in **x's dtype** — bf16 x with f32
  gamma gives bf16, which is what keeps the JAX package's default bf16
  step in bf16.  On a CUDA tensor it launches ``csrc/fused_norm.cu`` (or
  raises); on a CPU tensor it runs `norm_plain`, the kernel's plain
  version.  The backward has no kernel, as in JAX: recomputed f32
  statistics in torch (`_norm_grads`).

`kernel_eligible` applies the policy of `ops.policy` (``MXTPU_PALLAS``)
and the kernel's shape rules; the public wrappers take it when
``use_kernel`` is None.  `fused_layer_norm_reference` and
`fused_rms_norm_reference` run the kernel route on the plain version on
any device, by name: the oracle a run on the card is held against.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..base import MXNetError
from .. import kernels as _kernels
from .policy import kernel_active

__all__ = ["fused_layer_norm", "fused_rms_norm", "layer_norm_residual",
           "rms_norm_residual", "layer_norm_reference",
           "rms_norm_reference", "kernel_eligible", "norm_plain",
           "fused_layer_norm_reference", "fused_rms_norm_reference"]


# ---------------------------------------------------------------------------
# the reference route (math in the input dtype)
# ---------------------------------------------------------------------------

def _row(v, ndim):
    return v.reshape((1,) * (ndim - 1) + (v.shape[-1],))


def layer_norm_reference(x, gamma, beta, eps=1e-5, residual=None):
    """LN(+residual) over the last axis with ``npx.layer_norm``'s math:
    mean and variance in the input dtype, then the affine map against the
    parameters (dtypes promote)."""
    s = residual + x if residual is not None else x
    mean = s.mean(dim=-1, keepdim=True)
    var = s.var(dim=-1, keepdim=True, correction=0)
    y = (s - mean) * torch.rsqrt(var + eps)
    y = y * _row(gamma, s.dim()) + _row(beta, s.dim())
    return (y, s) if residual is not None else y


def rms_norm_reference(x, gamma, eps=1e-6, residual=None):
    """RMSNorm(+residual): ``y = s * rsqrt(mean(s^2) + eps) * gamma``."""
    s = residual + x if residual is not None else x
    ms = (s * s).mean(dim=-1, keepdim=True)
    y = s * torch.rsqrt(ms + eps) * _row(gamma, s.dim())
    return (y, s) if residual is not None else y


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------

def norm_plain(x2, res2, gamma, beta, eps, rms):
    """Plain version of the row kernel over 2-D (rows, h): the residual sum
    and the statistics in f32, ``y`` (and ``s``) in x's dtype.  Returns y,
    or (y, s) when `res2` is given."""
    x = x2.float()
    if res2 is not None:
        x = x + res2.float()
    inv_h = 1.0 / x.shape[-1]
    if rms:
        ms = (x * x).sum(dim=-1, keepdim=True) * inv_h
        y = x * torch.rsqrt(ms + eps)
    else:
        mean = x.sum(dim=-1, keepdim=True) * inv_h
        cent = x - mean
        var = (cent * cent).sum(dim=-1, keepdim=True) * inv_h
        y = cent * torch.rsqrt(var + eps)
    y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    y = y.to(x2.dtype)
    return y if res2 is None else (y, x.to(x2.dtype))


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/fused_norm.cu)
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        f = _kernels.load("fused_norm").mxt_fused_norm
        f.argtypes = [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P]
        f.restype = _I
        _fn = f
    return _fn


def _norm_cuda(x2, res2, gamma, beta, eps, rms):
    """Check the operands, then launch the row kernel on the current
    stream; returns y, or (y, s) when `res2` is given."""
    rows, h = x2.shape
    if x2.dtype not in _DTYPES:
        raise MXNetError(f"fused_norm kernel takes float32, bfloat16 or "
                         f"float16 x, got {x2.dtype}")
    ops = [("x", x2, x2.dtype, (rows, h)), ("gamma", gamma, None, (h,))]
    if res2 is not None:
        ops.append(("residual", res2, x2.dtype, (rows, h)))
    if beta is not None:
        ops.append(("beta", beta, gamma.dtype, (h,)))
    for name, t, dt, shape in ops:
        if t.dtype not in _DTYPES or (dt is not None and t.dtype != dt):
            raise MXNetError(f"fused_norm: {name} has dtype {t.dtype}")
        if tuple(t.shape) != shape:
            raise MXNetError(f"fused_norm: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if t.device != x2.device:
            raise MXNetError(f"fused_norm: {name} is on {t.device}, x on "
                             f"{x2.device}")
        if not t.is_contiguous():
            raise MXNetError(f"fused_norm kernel needs a contiguous {name}")
    if rows >= 2 ** 31 or h >= 2 ** 31:
        raise MXNetError(f"fused_norm kernel takes rows, h < 2**31; got "
                         f"{(rows, h)}")
    y = torch.empty_like(x2)
    s = None if res2 is None else torch.empty_like(x2)
    if rows and h:
        err = _kernel_fn()(
            x2.data_ptr(), None if res2 is None else res2.data_ptr(),
            gamma.data_ptr(), None if beta is None else beta.data_ptr(),
            y.data_ptr(), None if s is None else s.data_ptr(), rows, h,
            _DTYPES[x2.dtype], _DTYPES[gamma.dtype], int(rms), float(eps),
            torch.cuda.current_stream(x2.device).cuda_stream)
        if err:
            raise MXNetError(f"fused_norm kernel launch failed (cudaError_t "
                             f"{err})")
        _kernels.LAUNCHES["fused_norm"] += 1
    return y if s is None else (y, s)


def _forward(x2, res2, gamma, beta, eps, rms, launch):
    if launch:
        return _norm_cuda(x2, res2, gamma, beta, eps, rms)
    return norm_plain(x2, res2, gamma, beta, eps, rms)


# ---------------------------------------------------------------------------
# autograd: kernel (or plain) forward, torch backward on recomputed stats
# ---------------------------------------------------------------------------

def _norm_grads(s, gamma, dy, eps, rms, has_beta):
    """Cotangents of the normalised stream s, gamma and beta given dL/dy
    (``_norm_grads`` of the JAX package): f32 statistics recomputed from
    s; dgamma and dbeta summed in f32 and cast to gamma's dtype."""
    sf = s.float()
    dyf = dy.float()
    g = gamma.float().reshape(1, -1)
    if rms:
        rstd = torch.rsqrt((sf * sf).mean(dim=-1, keepdim=True) + eps)
        xhat = sf * rstd
        dxh = dyf * g
        ds = rstd * (dxh - xhat * (dxh * xhat).mean(dim=-1, keepdim=True))
    else:
        mean = sf.mean(dim=-1, keepdim=True)
        var = ((sf - mean) ** 2).mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        xhat = (sf - mean) * rstd
        dxh = dyf * g
        ds = rstd * (dxh - dxh.mean(dim=-1, keepdim=True)
                     - xhat * (dxh * xhat).mean(dim=-1, keepdim=True))
    dbeta = dyf.sum(dim=0).to(gamma.dtype) if has_beta else None
    dgamma = (dyf * xhat).sum(dim=0).to(gamma.dtype)
    return ds, dgamma, dbeta


class _FusedNorm(torch.autograd.Function):
    """Without a residual: saves x and gamma (``_fused_nores``)."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, rms, launch):
        y = _forward(x2, None, gamma, beta, eps, rms, launch)
        ctx.save_for_backward(x2, gamma)
        ctx.eps, ctx.rms, ctx.has_beta = eps, rms, beta is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        s, gamma = ctx.saved_tensors
        ds, dgamma, dbeta = _norm_grads(s, gamma, dy, ctx.eps, ctx.rms,
                                        ctx.has_beta)
        return ds.to(s.dtype), dgamma, dbeta, None, None, None


class _FusedNormResidual(torch.autograd.Function):
    """With a residual: returns (y, s) and saves s and gamma (``_fused``).
    s feeds both outputs, so its own cotangent adds to the norm's; x and
    the residual get the same gradient."""

    @staticmethod
    def forward(ctx, x2, res2, gamma, beta, eps, rms, launch):
        y, s = _forward(x2, res2, gamma, beta, eps, rms, launch)
        ctx.save_for_backward(s, gamma)
        ctx.eps, ctx.rms, ctx.has_beta = eps, rms, beta is not None
        return y, s

    @staticmethod
    def backward(ctx, dy, ds_out):
        s, gamma = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(s)
        ds, dgamma, dbeta = _norm_grads(s, gamma, dy, ctx.eps, ctx.rms,
                                        ctx.has_beta)
        if ds_out is not None:
            ds = ds + ds_out.float()
        dx = ds.to(s.dtype)
        return dx, dx, dgamma, dbeta, None, None, None


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def kernel_eligible(x, axis=-1) -> bool:
    """Should this call take the kernel route right now?  The policy
    (`ops.policy.kernel_active`), then the kernel's rules: the last axis of
    an input of rank >= 2 in a 2- or 4-byte float type."""
    if not kernel_active(x):
        return False
    if x.dim() < 2 or axis not in (-1, x.dim() - 1):
        return False
    return x.is_floating_point() and x.element_size() in (2, 4)


def _kernel_route(x, residual, gamma, beta, eps, rms, launch):
    lead, h = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, h)
    if launch:
        x2 = x2.contiguous()
        gamma = gamma.contiguous()
        beta = None if beta is None else beta.contiguous()
    if residual is None:
        return _FusedNorm.apply(x2, gamma, beta, eps, rms,
                                launch).reshape(*lead, h)
    r2 = residual.reshape(-1, h)
    if launch:
        r2 = r2.contiguous()
    y, s = _FusedNormResidual.apply(x2, r2, gamma, beta, eps, rms, launch)
    return y.reshape(*lead, h), s.reshape(*lead, h)


def _dispatch(x, residual, gamma, beta, eps, rms, use_kernel):
    if x.device.type not in ("cuda", "cpu"):
        raise MXNetError(f"fused_norm runs on cuda or cpu, not {x.device}")
    if use_kernel is None:
        use_kernel = kernel_eligible(x)
    if not use_kernel:
        if rms:
            return rms_norm_reference(x, gamma, eps=eps, residual=residual)
        return layer_norm_reference(x, gamma, beta, eps=eps,
                                    residual=residual)
    return _kernel_route(x, residual, gamma, beta, eps, rms,
                         x.device.type == "cuda")


def fused_layer_norm(x, gamma, beta, eps=1e-5, use_kernel=None):
    """LayerNorm over the last axis (the kernel route when eligible)."""
    return _dispatch(x, None, gamma, beta, eps, False, use_kernel)


def fused_rms_norm(x, gamma, eps=1e-6, use_kernel=None):
    """RMSNorm over the last axis (the kernel route when eligible)."""
    return _dispatch(x, None, gamma, None, eps, True, use_kernel)


def layer_norm_residual(x, residual, gamma, beta, eps=1e-5,
                        use_kernel=None) -> Tuple:
    """Fused ``s = residual + x; y = LN(s)``; returns ``(y, s)``."""
    return _dispatch(x, residual, gamma, beta, eps, False, use_kernel)


def rms_norm_residual(x, residual, gamma, eps=1e-6,
                      use_kernel=None) -> Tuple:
    """Fused ``s = residual + x; y = RMSNorm(s)``; returns ``(y, s)``."""
    return _dispatch(x, residual, gamma, None, eps, True, use_kernel)


def fused_layer_norm_reference(x, gamma, beta, eps=1e-5):
    """The kernel route of `fused_layer_norm` on the plain version, on any
    device, with no kernel launched — what an oracle `models.layers.
    LayerNorm` calls in place of ``ops.nn.layer_norm``."""
    return _kernel_route(x, None, gamma, beta, eps, False, False)


def fused_rms_norm_reference(x, gamma, eps=1e-6):
    """The kernel route of `fused_rms_norm` on the plain version, on any
    device (an oracle `models.layers.RMSNorm`'s ``norm``)."""
    return _kernel_route(x, None, gamma, None, eps, True, False)


def _last_axis(name, x, axis):
    if axis not in (-1, x.dim() - 1):
        raise ValueError(f"{name} normalises the last axis only, got "
                         f"axis={axis}")
