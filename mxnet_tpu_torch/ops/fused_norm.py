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

The launch is planned on the host (`_plan`, plain Python, memoised): the
"warp" variant for rows of at most 32 elements a lane (a group of lanes
owns whole rows, held in registers, reduced by shuffles; ``block_rows``
rows a block), the "block" variant for wider rows, 16-byte loads where
the row and the pointers allow, else one element.  ``block_rows`` is
JAX's tunable: `resolve_block_rows` takes the argument, then the tuned
config (``tune("fused_norm", (rows, h), dtype)``, `ops.autotune`), then
the card's `default_block_rows`; `_candidates`, `_roofline` and `_build`
(the trial launch) are registered at import.

`kernel_eligible` applies the policy of `ops.policy` (``MXTPU_PALLAS``)
and the kernel's shape rules; the public wrappers take it when
``use_kernel`` is None.  `fused_layer_norm_reference` and
`fused_rms_norm_reference` run the kernel route on the plain version on
any device, by name: the oracle a run on the card is held against.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..base import MXNetError
from .. import kernels as _kernels
from . import autotune
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
# the launch plan and JAX's block_rows tunable
# ---------------------------------------------------------------------------

WARP_ELEMS = (8, 16, 24, 32)   # elements a lane may hold ("warp" variant)
BLOCK_ELEMS = 32               # elements a thread may hold ("block")
BLOCK_THREADS = 512            # most threads of a "block" block
MAX_WARPS = 8                  # most warps of a "warp" block
_SUBLANES = 8                  # JAX's smallest block_rows
# the card's block_rows where nothing else chooses (JAX's is 128): the
# largest of these that still gives every SM a block, else the last.  On
# an H100 (`chip_smoke.py` k5, PERF.md) 32 (bf16) and 8-32 (f32) were the
# fastest of JAX's menu at (8192, 768), while 1280 rows at 32 (40 blocks)
# trailed `F.layer_norm` by 1.6x
DEFAULT_BLOCK_ROWS = (32, 16, 8)


def default_block_rows(rows: int, sm_count: int) -> int:
    """The card's block_rows for `rows` rows on `sm_count` SMs."""
    for br in DEFAULT_BLOCK_ROWS:
        if -(-rows // br) >= sm_count:
            return br
    return DEFAULT_BLOCK_ROWS[-1]


class NormPlan(NamedTuple):
    """One launch of the row kernel."""
    variant: str         # "warp": a group of lanes a row; "block": a block
    vec: int             # elements a load (16 bytes, or 1)
    lanes: int           # threads a row ("block": the block's threads)
    nv: int              # vectors a thread holds a tile
    elems: int           # registers of a thread's slice (the template)
    tiles: int           # passes over a row's vectors (1: in registers)
    warps: int           # warps a block
    block_rows: int      # rows a block ("warp"; "block": 1 a pass)
    rows_warp: int       # rows a warp takes in a block ("block": 0, it
                         # shares rows with the block)
    grid: int            # blocks
    source: str = "explicit"   # where block_rows came from


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


@functools.lru_cache(maxsize=None)
def _plan(rows: int, h: int, x_dtype, p_dtype, block_rows: int,
          sm_count: int, aligned: bool) -> NormPlan:
    """The launch for a (rows, h) call, plain Python: 16-byte loads when
    ``h * itemsize`` is a multiple of 16 and the pointers are aligned, else
    one element a load; rows of at most 32 elements a lane take the "warp"
    variant — the fewest lanes (a power of two) that leave each at most 8
    elements, up to 32, and ``block_rows`` rows a block of at most
    `MAX_WARPS` warps — wider rows the "block" variant, one row at a time
    per block of up to `BLOCK_THREADS` threads holding up to 32 elements
    each (tiles beyond that), as many persistent blocks as an SM's 2048
    threads hold.  `p_dtype` (gamma's) does not change the plan."""
    if isinstance(x_dtype, str):
        x_dtype = getattr(torch, autotune.dtype_name(x_dtype))
    item = torch.finfo(x_dtype).bits // 8
    vec = 16 // item if aligned and (h * item) % 16 == 0 else 1
    nvec = max(1, h // vec)
    if -(-nvec // 32) * vec <= WARP_ELEMS[-1]:
        lanes = min(32, _pow2_at_least(-(-nvec // max(1, 8 // vec))))
        nv = -(-nvec // lanes)
        elems = min(e for e in WARP_ELEMS if e >= nv * vec)
        gpw = 32 // lanes
        br = max(1, int(block_rows))
        warps = max(1, min(MAX_WARPS, -(-br // gpw)))
        return NormPlan("warp", vec, lanes, nv, elems, 1, warps, br,
                        gpw * -(-br // (warps * gpw)), max(1, -(-rows // br)))
    nvm = BLOCK_ELEMS // vec
    threads = min(BLOCK_THREADS, 32 * -(-nvec // (32 * nvm)))
    nv = min(nvm, -(-nvec // threads))
    tiles = -(-nvec // (threads * nv))
    grid = max(1, min(rows, sm_count * max(1, 2048 // threads)))
    return NormPlan("block", vec, threads, nv, BLOCK_ELEMS, tiles,
                    threads // 32, 1, 0, grid)


def _resolve(rows, h, dtype, block_rows, sm_count):
    """`resolve_block_rows` with its source."""
    if block_rows:
        return int(block_rows), "explicit"
    cfg = autotune.cached_config("fused_norm", (rows, h),
                                 autotune.dtype_name(dtype))
    if cfg is not None and "block_rows" in cfg:
        return max(_SUBLANES, min(int(cfg.block_rows), 1024)), "tuned"
    return default_block_rows(rows, sm_count), "default"


def resolve_block_rows(rows, h, dtype, block_rows=None,
                       sm_count: int = 132) -> int:
    """Rows a block for one call, in JAX's order (``mxnet_tpu/ops/pallas/
    fused_norm.py`` `_norm_pallas` / `_default_block_rows`): the argument,
    then the autotuner's kept config for (rows, h) in x's dtype (clamped to
    [8, 1024], as JAX clamps it), then the card's `default_block_rows`
    (where JAX has 128).  Pure lookup."""
    return _resolve(rows, h, dtype, block_rows, sm_count)[0]


# plans already made, keyed by shape, dtypes, device, alignment and the
# block_rows asked for, valid for the autotuner generation in `_memo_gen`
_memo: Dict[Any, NormPlan] = {}
_memo_gen = None


def _planned(rows, h, x_dtype, p_dtype, device, aligned,
             block_rows=None) -> NormPlan:
    """`_plan` for the block_rows `resolve_block_rows` picks, looked up
    once per key and `autotune.generation()`, not at each call."""
    global _memo_gen
    gen = autotune.generation()
    if gen != _memo_gen:
        _memo.clear()
        _memo_gen = gen
    key = (rows, h, x_dtype, p_dtype, device, aligned, block_rows)
    plan = _memo.get(key)
    if plan is None:
        sms = _kernels.sm_count(device)
        br, src = _resolve(rows, h, x_dtype, block_rows, sms)
        plan = _memo[key] = _plan(rows, h, x_dtype, p_dtype, br, sms,
                                  aligned)._replace(source=src)
    return plan


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
        f.argtypes = [_P] * 6 + [ctypes.c_longlong] + [_I] * 4 + \
            [ctypes.c_float] + [_I] * 9 + [_P]
        f.restype = _I
        _fn = f
    return _fn


def _aligned(*ts) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def _norm_cuda(x2, res2, gamma, beta, eps, rms, block_rows=None):
    """Check the operands, then launch the row kernel on the current
    stream at the plan for the block_rows `resolve_block_rows` picks;
    returns y, or (y, s) when `res2` is given."""
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
        plan = _planned(rows, h, x2.dtype, gamma.dtype, x2.device,
                        _aligned(x2, res2), block_rows)
        err = _kernel_fn()(
            x2.data_ptr(), None if res2 is None else res2.data_ptr(),
            gamma.data_ptr(), None if beta is None else beta.data_ptr(),
            y.data_ptr(), None if s is None else s.data_ptr(), rows, h,
            _DTYPES[x2.dtype], _DTYPES[gamma.dtype], int(rms), float(eps),
            int(plan.variant == "block"), 32 * plan.warps, plan.lanes,
            plan.vec, plan.nv, plan.elems, plan.tiles, plan.block_rows,
            plan.grid, torch.cuda.current_stream(x2.device).cuda_stream)
        if err:
            raise MXNetError(f"fused_norm kernel launch failed (cudaError_t "
                             f"{err}, plan {plan})")
        _kernels.count_launch("fused_norm", x2.dtype)
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
    device, with no kernel launched — what a plain twin's
    `gluon.nn.LayerNorm` calls in place of ``ops.nn.layer_norm``."""
    return _kernel_route(x, None, gamma, beta, eps, False, False)


def fused_layer_norm_residual_reference(x, residual, gamma, beta, eps=1e-5):
    """The kernel route of `layer_norm_residual` on the plain version, on
    any device, with no kernel launched — a plain twin's
    `gluon.nn.LayerNorm` ``_norm_residual``.  Returns ``(y, s)``."""
    return _kernel_route(x, residual, gamma, beta, eps, False, False)


def fused_rms_norm_reference(x, gamma, eps=1e-6):
    """The kernel route of `fused_rms_norm` on the plain version, on any
    device (a plain twin's `gluon.nn.RMSNorm` ``_norm``)."""
    return _kernel_route(x, None, gamma, None, eps, True, False)


def _last_axis(name, x, axis):
    if axis not in (-1, x.dim() - 1):
        raise ValueError(f"{name} normalises the last axis only, got "
                         f"axis={axis}")


# ---------------------------------------------------------------------------
# autotune registration: block_rows, as in the JAX package —
# `tune("fused_norm", (rows, h), dtype)` times the kernel at each candidate
# and `resolve_block_rows` picks the kept one up
# ---------------------------------------------------------------------------

def _candidates(shapes, dtype):
    """JAX's menu (``fused_norm.py`` `_candidates`): 8 to 1024 rows a
    block, up to twice the rows."""
    rows = shapes[0] if shapes else 4096
    return [autotune.BlockConfig(block_rows=br)
            for br in (8, 16, 32, 64, 128, 256, 512, 1024)
            if br <= max(_SUBLANES, rows * 2)]


def _roofline(config, shapes, dtype):
    """JAX's count (`_roofline`): x read and y written, one step a
    block."""
    rows = shapes[0] if shapes else 4096
    h = shapes[1] if len(shapes) > 1 else 1024
    itemsize = 2 if "16" in str(dtype) else 4
    return {"flops": 8.0 * rows * h,
            "bytes": 2.0 * rows * h * itemsize,
            "steps": max(1.0, rows / config.block_rows)}


def _at_inputs(shapes, dtype, device):
    """JAX's `_build` inputs: x from ``RandomState(0).randn(rows, h)`` in
    `dtype`, gamma ones, beta zeros."""
    import numpy as np
    rows = shapes[0] if shapes else 4096
    h = shapes[1] if len(shapes) > 1 else 1024
    dt = getattr(torch, autotune.dtype_name(dtype))
    x = torch.from_numpy(np.random.RandomState(0).randn(rows, h)
                         .astype(np.float32)).to(device, dt)
    return x, torch.ones(h, dtype=dt, device=device), \
        torch.zeros(h, dtype=dt, device=device)


def _build(config, shapes, dtype):
    """The trial launch: one LayerNorm at ``config.block_rows`` — the CUDA
    kernel on the card (it counts in `kernels.LAUNCHES`), the plain
    version on the CPU.  Returns the thunk."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    x, g, b = _at_inputs(shapes, dtype, dev)
    if dev.type == "cpu":
        return lambda: norm_plain(x, None, g, b, 1e-5, False)
    br = int(config.block_rows)
    return lambda: _norm_cuda(x, None, g, b, 1e-5, False, block_rows=br)


autotune.register_tunable("fused_norm", _candidates, _build, _roofline)
