"""`mx.npx` — MXNet's operator extensions over `ndarray`s (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``).

The ops that hold a kernel go through the port's ops, and so through the
hand-written CUDA kernels on the card: `layer_norm`,
`layer_norm_residual`, `rms_norm` and `rms_norm_residual` through
`ops.nn` to the fused-norm kernel, `softmax_cross_entropy` to the
cross-entropy kernels, `multi_head_attention` through `ops.attention` to
the flash kernels (the plain versions on a CPU tensor).  The rest are
torch bodies with the JAX package's semantics.  Autograd is torch's: an op
is recorded inside ``autograd.record()``.

Not here yet, each raising `MXNetError` by name: convolution, pooling and
the image / spatial ops (ROADMAP.md A11), ``rnn``, ``custom`` and
``intgemm_fully_connected`` (A16).  ``foreach``, ``while_loop`` and
``cond`` run eagerly (the blocks are not captured; a captured step comes
with A8).
"""
from __future__ import annotations

import builtins
import math

import numpy as _onp
import torch
import torch.nn.functional as F

from .. import autograd as _ag
from .. import random as _rng
from ..base import MXNetError, UnportedModule, unported
from ..device import cpu, gpu, num_gpus  # noqa: F401
from ..dlpack import (from_dlpack, to_dlpack_for_read,  # noqa: F401
                      to_dlpack_for_write)
from ..ndarray.ndarray import apply, ndarray, to_torch_dtype, wrap
from ..numpy import random  # noqa: F401
from ..numpy.random import bernoulli, normal_n, uniform_n  # noqa: F401
from ..ops import attention as _att
from ..ops import nn as _nn
from ..ops.nn import remat_call as _remat_call
from ..ops.nn import resolve_remat_policy  # noqa: F401
from ..util import (is_np_array, is_np_shape, reset_np,  # noqa: F401
                    set_np, set_np_shape)

__all__ = [
    "activation", "relu", "sigmoid", "tanh", "softrelu", "softsign", "gelu",
    "log_sigmoid", "mish", "hard_sigmoid",
    "silu", "leaky_relu", "elu", "selu", "prelu", "softmax", "log_softmax",
    "masked_softmax", "masked_log_softmax", "fully_connected", "convolution",
    "deconvolution", "pooling", "batch_norm", "layer_norm",
    "layer_norm_residual", "rms_norm", "rms_norm_residual", "group_norm",
    "instance_norm", "l2_normalization", "dropout", "embedding", "one_hot",
    "pick", "topk", "slice", "reshape", "index_add", "index_update",
    "constraint_check", "sequence_mask", "arange_like", "shape_array",
    "reshape_like", "broadcast_like", "gamma", "gammaln", "erf", "erfinv",
    "smooth_l1", "gather_nd", "scatter_nd", "cast", "amp_cast",
    "amp_multicast",
    "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
    "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
    "sldwin_atten_mask_like", "sldwin_atten_score", "sldwin_atten_context",
    "multi_head_attention", "ctc_loss", "foreach", "while_loop", "cond",
    "remat_call", "resolve_remat_policy",
    "grid_generator", "bilinear_sampler", "spatial_transformer",
    "correlation", "im2col", "col2im", "deformable_convolution",
    "softmax_cross_entropy",
    "save", "load", "waitall", "set_np", "reset_np", "is_np_array",
    "seed", "rnn", "intgemm_fully_connected", "custom",
    "random", "image", "cpu", "gpu", "tpu", "num_gpus", "num_tpus",
    "batch_dot", "bernoulli", "from_numpy", "from_dlpack",
    "to_dlpack_for_read", "to_dlpack_for_write", "savez", "normal_n",
    "uniform_n",
]

#: the npx names the port raises on, with their ROADMAP.md items
UNPORTED = {n: "A11" for n in (
    "convolution", "deconvolution", "pooling", "grid_generator",
    "bilinear_sampler", "spatial_transformer", "correlation", "im2col",
    "col2im", "deformable_convolution")}
UNPORTED.update({n: "A16" for n in ("rnn", "custom",
                                    "intgemm_fully_connected")})
for _n, _item in UNPORTED.items():
    globals()[_n] = unported(f"mx.npx.{_n}", _item)
image = UnportedModule("mx.npx.image", "A11")


def tpu(device_id=0):
    from ..device import tpu as _tpu
    return _tpu(device_id)


def num_tpus():
    return 0


def _unary(fn, name):
    def op(data, **kwargs):
        return apply(lambda x: fn(x, **kwargs) if kwargs else fn(x), data)
    op.__name__ = name
    return op


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

relu = _unary(torch.relu, "relu")
sigmoid = _unary(torch.sigmoid, "sigmoid")
tanh = _unary(torch.tanh, "tanh")
softsign = _unary(F.softsign, "softsign")
silu = _unary(F.silu, "silu")
softrelu = _unary(F.softplus, "softrelu")
erf = _unary(torch.erf, "erf")
erfinv = _unary(torch.erfinv, "erfinv")
gammaln = _unary(torch.lgamma, "gammaln")
gamma = _unary(lambda x: torch.exp(torch.lgamma(x)), "gamma")
log_sigmoid = _unary(F.logsigmoid, "log_sigmoid")
mish = _unary(lambda x: x * torch.tanh(F.softplus(x)), "mish")
hard_sigmoid = _unary(
    lambda x, alpha=0.2, beta=0.5: torch.clamp(alpha * x + beta, 0.0, 1.0),
    "hard_sigmoid")


def gelu(data, approximation="erf"):
    return apply(lambda x: _nn.gelu(x, approximation), data)


def elu(data, alpha=1.0):
    return apply(lambda x: _nn.elu(x, alpha), data)


def selu(data):
    return apply(_nn.selu, data)


def prelu(data, gamma_):
    return apply(_nn.prelu, data, gamma_)


def leaky_relu(data, gamma_=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, **kwargs):
    if act_type == "leaky":
        return apply(lambda x: torch.where(x >= 0, x, slope * x), data)
    if act_type == "elu":
        return apply(lambda x: torch.where(x >= 0, x,
                                           slope * torch.expm1(x)), data)
    if act_type == "selu":
        return selu(data)
    if act_type == "gelu":
        return gelu(data, approximation="tanh")
    if act_type == "prelu":
        return prelu(data, gamma_)
    if act_type == "rrelu":
        s = (lower_bound + upper_bound) / 2.0
        return apply(lambda x: torch.where(x >= 0, x, s * x), data)
    raise MXNetError(f"unknown leaky_relu act_type {act_type}")


def activation(data, act_type="relu", **kwargs):
    return apply(lambda x: _nn.activation(x, act_type), data)


# ---------------------------------------------------------------------------
# softmax family
# ---------------------------------------------------------------------------

def _length_mask(x, ln, axis):
    axis %= x.dim()
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    idx = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    return idx < ln.unsqueeze(axis)


def _cast(y, dtype):
    return y if dtype is None else y.to(to_torch_dtype(dtype))


def softmax(data, length=None, axis=-1, temperature=None, use_length=False,
            dtype=None):
    t = 1.0 if temperature is None else temperature
    if use_length and length is not None:
        def fn(x, ln):
            m = _length_mask(x, ln, axis)
            y = torch.softmax(torch.where(m, x / t, -math.inf), dim=axis)
            return _cast(torch.where(m, y, 0.0), dtype)
        return apply(fn, data, length)
    return apply(lambda x: _cast(torch.softmax(x / t, dim=axis), dtype),
                 data)


def log_softmax(data, axis=-1, temperature=None, dtype=None,
                use_length=False, length=None):
    t = 1.0 if temperature is None else temperature
    if use_length and length is not None:
        def fn(x, ln):
            m = _length_mask(x, ln, axis)
            y = torch.log_softmax(torch.where(m, x / t, -math.inf),
                                  dim=axis)
            return _cast(torch.where(m, y, -math.inf), dtype)
        return apply(fn, data, length)
    return apply(lambda x: _cast(torch.log_softmax(x / t, dim=axis),
                                 dtype), data)


def masked_softmax(data, mask=None, axis=-1, temperature=1.0, dtype=None):
    if mask is None:
        return softmax(data, axis=axis, temperature=temperature, dtype=dtype)

    def fn(x, m):
        m = m.to(torch.bool)
        y = torch.softmax(torch.where(m, x / temperature, -math.inf),
                          dim=axis)
        return _cast(torch.where(m, y, 0.0), dtype)
    return apply(fn, data, mask)


def masked_log_softmax(data, mask=None, axis=-1, temperature=1.0,
                       dtype=None):
    if mask is None:
        return log_softmax(data, axis=axis, temperature=temperature,
                           dtype=dtype)

    def fn(x, m):
        m = m.to(torch.bool)
        y = torch.log_softmax(torch.where(m, x / temperature, -math.inf),
                              dim=axis)
        return _cast(torch.where(m, y, -math.inf), dtype)
    return apply(fn, data, mask)


def softmax_cross_entropy(logits, labels, reduction="none"):
    """Sparse-label cross entropy over the last axis: the streaming
    cross-entropy kernels on the card (`ops.nn.softmax_cross_entropy`).
    ``reduction="sum"`` gives the reference op's summed (1,) output."""
    return apply(lambda x, y: _nn.softmax_cross_entropy(x, y, reduction),
                 logits, labels)


# ---------------------------------------------------------------------------
# dense and normalisation
# ---------------------------------------------------------------------------

def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """``x @ weight.T + bias`` (weight (num_hidden, in_units)); `flatten`
    collapses every axis of `x` after the first."""
    if no_bias or bias is None:
        return apply(lambda a, w: _nn.fully_connected(a, w, None, flatten),
                     x, weight)
    return apply(lambda a, w, b: _nn.fully_connected(a, w, b, flatten),
                 x, weight, bias)


def layer_norm(x, gamma_, beta, axis=-1, eps=1e-5):
    """LayerNorm over `axis`: the last axis through the fused-norm kernel
    on the card (`ops.nn.layer_norm`)."""
    return apply(lambda a, g, b: _nn.layer_norm(a, g, b, axis, eps),
                 x, gamma_, beta)


def layer_norm_residual(x, residual, gamma_, beta, axis=-1, eps=1e-5):
    """``s = residual + x; y = LN(s)``; returns ``(y, s)`` (one fused-norm
    launch on the card)."""
    return apply(lambda a, r, g, b: _nn.layer_norm_residual(
        a, r, g, b, axis, eps), x, residual, gamma_, beta)


def rms_norm(x, gamma_, axis=-1, eps=1e-6):
    return apply(lambda a, g: _nn.rms_norm(a, g, axis, eps), x, gamma_)


def rms_norm_residual(x, residual, gamma_, axis=-1, eps=1e-6):
    return apply(lambda a, r, g: _nn.rms_norm_residual(a, r, g, axis, eps),
                 x, residual, gamma_)


def batch_norm(x, gamma_, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1, min_calib_range=None,
               max_calib_range=None, cudnn_off=False):
    """BatchNorm: in training mode (``autograd.is_training()``) the
    batch's mean and biased variance normalise `x` and the running
    statistics move in place, MXNet's way; otherwise the running ones
    normalise."""
    training = _ag.is_training() and not use_global_stats

    def fn(xv, g, b, rm, rv):
        ax = axis % xv.dim()
        red = tuple(i for i in range(xv.dim()) if i != ax)
        shape = [1] * xv.dim()
        shape[ax] = xv.shape[ax]
        g_ = torch.ones_like(g) if fix_gamma else g
        if training:
            mean = xv.mean(dim=red)
            var = xv.var(dim=red, correction=0)
            with torch.no_grad():
                rm.copy_(momentum * rm + (1 - momentum) * mean.detach())
                rv.copy_(momentum * rv + (1 - momentum) * var.detach())
        else:
            mean, var = rm, rv
        y = (xv - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) +
                                                     eps)
        y = y * g_.reshape(shape) + b.reshape(shape)
        return (y, mean, var) if output_mean_var else y
    return apply(fn, x, gamma_, beta, running_mean, running_var)


def group_norm(x, gamma_, beta, num_groups=1, eps=1e-5):
    return apply(lambda a, g, b: _nn.group_norm(a, g, b, num_groups, eps),
                 x, gamma_, beta)


def instance_norm(x, gamma_, beta, eps=1e-5):
    return apply(lambda a, g, b: _nn.instance_norm(a, g, b, eps),
                 x, gamma_, beta)


def l2_normalization(data, eps=1e-10, mode="instance"):
    def fn(x):
        if mode == "instance":
            axes = tuple(range(1, x.dim()))
        elif mode == "channel":
            axes = (1,)
        else:
            axes = tuple(range(2, x.dim()))
        return x / torch.sqrt((x * x).sum(dim=axes, keepdim=True) + eps)
    return apply(fn, data)


# ---------------------------------------------------------------------------
# dropout, embedding and the rest
# ---------------------------------------------------------------------------

def dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False):
    """Inverted dropout, active in training mode or with
    ``mode="always"``; the mask comes from the device's generator
    (`mxnet_tpu_torch.random.generator`)."""
    active = (_ag.is_training() or mode == "always") and p > 0
    if not active:
        return data
    return apply(lambda x: _nn.dropout(x, p, _rng.generator(x.device),
                                       True, axes), data)


def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    """Row lookup of `weight` at `data` (clipped into range)."""
    if sparse_grad:
        raise MXNetError("embedding(sparse_grad=True): row-sparse gradients "
                         "are not ported yet (ROADMAP.md A16)")
    return apply(lambda i, w: _cast(_nn.embedding(i, w), dtype),
                 data, weight)


def one_hot(data, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    def fn(idx):
        oh = F.one_hot(idx.long(), depth)
        return _cast(oh * (on_value - off_value) + off_value, dtype)
    return apply(fn, data)


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    return apply(lambda x, i: _nn.pick(x, i, axis, keepdims), data, index)


def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    if ret_typ == "mask":
        raise MXNetError("topk ret_typ='mask' not supported")

    def fn(x):
        v, i = torch.topk(x, k, dim=axis, largest=not is_ascend,
                          sorted=True)
        if ret_typ == "value":
            return v
        if ret_typ == "both":
            return v, _cast(i, dtype)
        return _cast(i, dtype)
    return apply(fn, data)


def slice(data, begin, end, step=None):  # noqa: A001
    """MXNet's ``slice``: per-axis begin / end / step, None for the full
    range."""
    def fn(x):
        nd = x.dim()
        b = tuple(begin) + (None,) * (nd - len(begin))
        e = tuple(end) + (None,) * (nd - len(end))
        st = tuple(step) + (None,) * (nd - len(step)) if step else \
            (None,) * nd
        return x[tuple(builtins.slice(*z) for z in zip(b, e, st))]
    return apply(fn, data)


def _reshape_shape(in_shape, newshape, reverse):
    """MXNet's special reshape codes: -1 infer, -2 copy one dim, -3 drop a
    size-1 dim, -4 copy the rest, -5 merge two dims, -6 split one dim into
    the next two spec values; `reverse` matches from the right."""
    orig = tuple(in_shape)
    spec = [newshape] if isinstance(newshape, int) else list(newshape)
    if reverse:
        in_shape, spec = tuple(in_shape)[::-1], spec[::-1]

    def need(idx, code):
        if idx >= len(in_shape):
            raise MXNetError(
                f"npx.reshape {code}: special code consumes input dim "
                f"{idx} but input has only {len(in_shape)} dims "
                f"(shape {orig})")

    out, i, j = [], 0, 0
    while j < len(spec):
        sv = spec[j]
        if sv == -4:
            out.extend(in_shape[i:])
            i = len(in_shape)
        elif sv == -2:
            need(i, -2)
            out.append(in_shape[i])
            i += 1
        elif sv == -3:
            need(i, -3)
            if in_shape[i] != 1:
                raise MXNetError(f"npx.reshape -3: input dim {i} is "
                                 f"{in_shape[i]}, not 1")
            i += 1
        elif sv == -5:
            need(i + 1, -5)
            out.append(in_shape[i] * in_shape[i + 1])
            i += 2
        elif sv == -6:
            need(i, -6)
            if j + 2 >= len(spec):
                raise MXNetError(f"npx.reshape -6: needs two following spec "
                                 f"values, got {spec[j + 1:]}")
            d = in_shape[i]
            i += 1
            av, bv = spec[j + 1], spec[j + 2]
            av = d // bv if av == -1 else av
            bv = d // av if bv == -1 else bv
            if av * bv != d:
                raise MXNetError(f"npx.reshape -6: {av}*{bv} != {d}")
            out.extend([av, bv])
            j += 2
        else:
            out.append(sv)
            i += 1
        j += 1
    if reverse:
        out = out[::-1]
    total = math.prod(in_shape)
    if -1 in out:
        if out.count(-1) > 1:
            raise MXNetError("npx.reshape: one and only one dim can be "
                             "inferred")
        known = math.prod(d for d in out if d != -1)
        if known == 0 or total % known:
            raise MXNetError(f"npx.reshape: cannot infer -1: {total} "
                             f"elements do not divide by {known}")
        out[out.index(-1)] = total // known
    elif math.prod(out) != total:
        raise MXNetError(f"npx.reshape: cannot reshape array of shape "
                         f"{orig} into shape {tuple(out)}")
    return tuple(out)


def reshape(a, newshape, reverse=False, order="C"):
    shape = _reshape_shape(a.shape, newshape, reverse)
    return apply(lambda x: x.reshape(shape), a)


def _index_scatter(name, accumulate):
    def op(a, ind, val):
        def fn(av, iv, vv):
            iv = torch.atleast_1d(iv.long())
            rows = (iv,) if iv.dim() == 1 else tuple(iv)
            n = rows[0].shape[0]
            tail = tuple(av.shape[len(rows):])
            vb = vv.to(av.dtype).broadcast_to((n,) + tail)
            return av.index_put(rows, vb, accumulate=accumulate)
        return apply(fn, a, ind, val)
    op.__name__ = name
    return op


index_add = _index_scatter("index_add", True)
index_update = _index_scatter("index_update", False)


def constraint_check(condition, msg="Constraint violated"):
    """Raise ValueError where `condition` holds a False, else True."""
    c = condition._data if isinstance(condition, ndarray) else \
        torch.as_tensor(condition)
    if not bool(c.all()):
        raise ValueError(msg)
    return apply(lambda t: t.all(), condition)


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data

    def fn(x, ln):
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        steps = torch.arange(x.shape[axis], device=x.device).reshape(shape)
        batch_axis = 1 - axis
        lshape = [1] * x.dim()
        lshape[batch_axis] = x.shape[batch_axis]
        return torch.where(steps < ln.reshape(lshape), x,
                           torch.as_tensor(value, dtype=x.dtype,
                                           device=x.device))
    return apply(fn, data, sequence_length)


def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None, ctx=None):
    def fn(x):
        if axis is None:
            n = x.numel()
            r = start + step * torch.arange(n, dtype=torch.float32,
                                            device=x.device)
            return r.reshape(x.shape)
        n = x.shape[axis]
        return (start + step * torch.arange(n, device=x.device).to(
            x.dtype)).to(x.dtype)
    return apply(fn, data)


def shape_array(data):
    return wrap(torch.tensor(data.shape, dtype=torch.int32,
                             device=data._data.device))


def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    def rng(n, b, e):
        b = 0 if b is None else (b + n if b < 0 else b)
        e = n if e is None else (e + n if e < 0 else e)
        return b, e

    def fn(a, b):
        if lhs_begin is None and lhs_end is None and rhs_begin is None \
                and rhs_end is None:
            return a.reshape(b.shape)
        lb, le = rng(a.dim(), lhs_begin, lhs_end)
        rb, re_ = rng(b.dim(), rhs_begin, rhs_end)
        return a.reshape(tuple(a.shape[:lb]) + tuple(b.shape[rb:re_]) +
                         tuple(a.shape[le:]))
    return apply(fn, lhs, rhs)


def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    return apply(lambda a, b: a.broadcast_to(b.shape), lhs, rhs)


def smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    return apply(lambda x: torch.where(x.abs() < 1.0 / s2, 0.5 * s2 * x * x,
                                       x.abs() - 0.5 / s2), data)


def gather_nd(data, indices):
    def fn(x, idx):
        idx = idx.long()
        return x[tuple(idx[i] for i in range(idx.shape[0]))]
    return apply(fn, data, indices)


def scatter_nd(data, indices, shape):
    def fn(d, idx):
        idx = idx.long()
        out = torch.zeros(tuple(shape), dtype=d.dtype, device=d.device)
        out[tuple(idx[i] for i in range(idx.shape[0]))] = d
        return out
    return apply(fn, data, indices)


def cast(data, dtype):
    return data.astype(dtype)


def amp_cast(data, dtype):
    """Cast between float dtypes; integer and bool arrays pass through."""
    if not data._data.is_floating_point():
        return data
    return data.astype(dtype)


def amp_multicast(*data, num_outputs=None, cast_narrow=False):
    ts = [d._data for d in data]
    widest = ts[0].dtype
    for t in ts[1:]:
        widest = torch.promote_types(widest, t.dtype)
    target = builtins.min((t.dtype for t in ts),
                          key=lambda d: torch.finfo(d).bits) \
        if cast_narrow else widest
    return tuple(wrap(t.to(target)) for t in ts)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """Q K^T / sqrt(d) over an interleaved (L, B, 3E) input: (B*H, L, L)."""
    def fn(qkv):
        lq, b, e3 = qkv.shape
        hd = e3 // 3 // heads
        x = qkv.reshape(lq, b, heads, 3, hd)
        q = x[:, :, :, 0].permute(1, 2, 0, 3).reshape(b * heads, lq, hd)
        k = x[:, :, :, 1].permute(1, 2, 0, 3).reshape(b * heads, lq, hd)
        return torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(hd)
    return apply(fn, queries_keys_values)


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1):
    def fn(qkv, att):
        lq, b, e3 = qkv.shape
        emb = e3 // 3
        hd = emb // heads
        v = qkv.reshape(lq, b, heads, 3, hd)[:, :, :, 2].permute(
            1, 2, 0, 3).reshape(b * heads, lq, hd)
        ctx = torch.einsum("bqk,bkd->bqd", att, v)
        return ctx.reshape(b, heads, lq, hd).permute(2, 0, 1, 3).reshape(
            lq, b, emb)
    return apply(fn, queries_keys_values, attention)


def interleaved_matmul_encdec_qk(queries, keys_values, heads=1):
    def fn(q, kv):
        lq, b, emb = q.shape
        lk = kv.shape[0]
        hd = emb // heads
        qh = q.reshape(lq, b, heads, hd).permute(1, 2, 0, 3).reshape(
            b * heads, lq, hd)
        kh = kv.reshape(lk, b, heads, 2, hd)[:, :, :, 0].permute(
            1, 2, 0, 3).reshape(b * heads, lk, hd)
        return torch.einsum("bqd,bkd->bqk", qh, kh) / math.sqrt(hd)
    return apply(fn, queries, keys_values)


def interleaved_matmul_encdec_valatt(keys_values, attention, heads=1):
    def fn(kv, att):
        lk, b, e2 = kv.shape
        emb = e2 // 2
        hd = emb // heads
        v = kv.reshape(lk, b, heads, 2, hd)[:, :, :, 1].permute(
            1, 2, 0, 3).reshape(b * heads, lk, hd)
        lq = att.shape[1]
        ctx = torch.einsum("bqk,bkd->bqd", att, v)
        return ctx.reshape(b, heads, lq, hd).permute(2, 0, 1, 3).reshape(
            lq, b, emb)
    return apply(fn, keys_values, attention)


def sldwin_atten_mask_like(score, dilation, valid_length, num_heads=1,
                           symmetric=True, w=1):
    """The sliding-window attention mask (1 inside the window and the
    valid length, else 0) of a (B*H, L, W) score."""
    def fn(s, vl):
        bh, lq, wlen = s.shape
        i = torch.arange(lq, device=s.device)[:, None]
        offs = (torch.arange(wlen, device=s.device)[None, :] -
                wlen // 2) * dilation
        absj = i + offs
        ok = (absj >= 0) & (absj < lq)
        if not symmetric:
            ok = ok & (offs <= 0)
        vl_ = torch.repeat_interleave(vl, num_heads)
        ok = ok[None] & (absj[None] < vl_[:, None, None]) & \
            (i[None] < vl_[:, None, None])
        return ok.to(s.dtype)
    return apply(fn, score, valid_length)


def _sldwin_indices(lq, w, dilation, symmetric, device):
    wlen = (2 * w + 1) if symmetric else (w + 1)
    i = torch.arange(lq, device=device)[:, None]
    j = i + (torch.arange(wlen, device=device)[None, :] - w) * dilation
    return j.clamp(0, lq - 1), wlen


def sldwin_atten_score(query, key, dilation, w=1, symmetric=True):
    """Banded Q K^T over (B*H, L, D) inputs: (B*H, L, W)."""
    def fn(q, k):
        bh, lq, hd = q.shape
        j, wlen = _sldwin_indices(lq, w, int(dilation), symmetric, q.device)
        kg = k[:, j.reshape(-1), :].reshape(bh, lq, wlen, hd)
        return torch.einsum("bld,blwd->blw", q, kg) / math.sqrt(hd)
    return apply(fn, query, key)


def sldwin_atten_context(score, value, dilation, w=1, symmetric=True):
    def fn(s, v):
        bh, lq, wlen = s.shape
        j, _ = _sldwin_indices(lq, w, int(dilation), symmetric, s.device)
        vg = v[:, j.reshape(-1), :].reshape(bh, lq, wlen, v.shape[-1])
        return torch.einsum("blw,blwd->bld", s, vg)
    return apply(fn, score, value)


def multi_head_attention(query, key, value, num_heads, mask=None,
                         dropout_p=0.0, causal=False, use_flash=True,
                         window=None, window_symmetric=True,
                         rope_theta=None, num_kv_heads=None):
    """Multi-head attention over projected (B, L, E) arrays: the flash
    kernels on the card (`ops.attention.multi_head_attention`); dropout in
    training mode, from the device's default generator."""
    training = _ag.is_training()
    return apply(lambda q, k, v, m: _att.multi_head_attention(
        q, k, v, num_heads, mask=m, dropout_p=dropout_p, causal=causal,
        use_flash=use_flash, window=window,
        window_symmetric=window_symmetric, rope_theta=rope_theta,
        num_kv_heads=num_kv_heads, training=training),
        query, key, value, mask)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    return apply(lambda d, lb, dl, ll: _nn.ctc_loss(
        d, lb, dl, ll, use_data_lengths, use_label_lengths, blank_label),
        data, label, data_lengths, label_lengths)


def remat_call(fn, *args, policy=None):
    """`ops.nn.remat_call` over arrays: `fn` takes and returns arrays.  The
    backward's recompute runs `fn` as recorded, as the forward did."""
    def body(*ts):
        with _ag._Scope(True, None):
            out = fn(*[wrap(t) for t in ts])
        return out._data if isinstance(out, ndarray) else out
    return apply(lambda *ts: _remat_call(body, *ts, policy=policy), *args)


# ---------------------------------------------------------------------------
# control flow (eager)
# ---------------------------------------------------------------------------

def foreach(body, data, init_states):
    """Run ``body(step_data, states) -> (out, states)`` over the first
    axis of `data`; returns the stacked outputs and the final states."""
    single_data = isinstance(data, ndarray)
    single_state = isinstance(init_states, ndarray)
    datas = [data] if single_data else list(data)
    states = init_states if single_state else list(init_states)
    outs = []
    for i in range(datas[0].shape[0]):
        xs = [d[i] for d in datas]
        out, states = body(xs[0] if single_data else xs, states)
        outs.append([out] if isinstance(out, ndarray) else list(out))
    from ..numpy import stack
    stacked = [stack([o[j] for o in outs]) for j in range(len(outs[0]))]
    out = stacked[0] if len(stacked) == 1 else tuple(stacked)
    if not single_state:
        states = list(states)
    return out, states


def while_loop(cond_fn, func, loop_vars, max_iterations=None):
    """``loop_vars = func(loop_vars)`` while ``cond_fn(loop_vars)`` (and at
    most `max_iterations` times); returns the final loop variables."""
    single = isinstance(loop_vars, ndarray)
    lv = loop_vars if single else list(loop_vars)
    n = 0
    while bool(cond_fn(lv)) and (max_iterations is None or
                                 n < max_iterations):
        r = func(lv)
        lv = r if single else ([r] if isinstance(r, ndarray) else list(r))
        n += 1
    return lv


def cond(pred, then_func, else_func, inputs=()):
    """``then_func(*inputs)`` if `pred` holds, else ``else_func(*inputs)``
    (a single output comes back as itself)."""
    ins = [inputs] if isinstance(inputs, ndarray) else list(inputs)
    r = then_func(*ins) if bool(pred) else else_func(*ins)
    if isinstance(r, (tuple, list)) and len(r) == 1:
        return r[0]
    return r


# ---------------------------------------------------------------------------
# files, devices, seeds
# ---------------------------------------------------------------------------

def save(fname, data):
    """Save an array, a list or a dict of arrays as ``.npz`` (readable by
    the JAX package's ``npx.load``)."""
    from ..ndarray import save as _save
    _save(fname, data)


def load(fname):
    """Load an ``.npz`` into a dict of arrays on the current device."""
    from ..ndarray import load as _load
    out = _load(fname)
    return out if isinstance(out, dict) else \
        {f"arr_{i}": a for i, a in enumerate(out)}


def savez(file, *args, **kwargs):
    """NumPy's ``savez``: positional arrays as ``arr_0`` ..., keywords
    under their names."""
    data = {f"arr_{i}": a for i, a in enumerate(args)}
    overlap = set(data) & set(kwargs)
    if overlap:
        raise ValueError(f"savez name collision: {sorted(overlap)}")
    data.update(kwargs)
    save(file, data)


def waitall():
    from ..engine import waitall as _w
    _w()


def is_np_default_dtype():
    return False


def seed(s):
    _rng.seed(s)


def from_numpy(ndarray_, zero_copy=True):
    """A host NumPy array onto the current device: float64 takes the
    default float, other dtypes their own (int64 as int32)."""
    from ..numpy import array
    a = _onp.asarray(ndarray_)
    if a.dtype in (_onp.float64, _onp.complex128):
        return array(a)
    return array(a, dtype=a.dtype)


def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Batched matrix product over the leading axes."""
    def fn(a, b):
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply(fn, lhs, rhs)
