"""The ``numpy_extension`` ops on the BERT training path, in plain torch
(counterparts of ``mxnet_tpu/numpy_extension/__init__.py``).

Dtype flow follows the JAX package's, route for route, so a module
computes what its JAX counterpart computes.  The norms dispatch as
``npx.layer_norm`` does (`ops.policy`, ``MXTPU_PALLAS``): on the kernel
route (the default on the card) the fused row kernel returns x's dtype,
so a bf16 model stays bf16; on the reference route a bf16 activation
meeting an f32 LayerNorm gain comes out f32.  `fully_connected` multiplies
in the promoted type of its operands (``jnp.matmul`` promotes;
``torch.matmul`` would refuse).
Random ops take an explicit `torch.Generator` where the JAX package draws
from its global key.

Each op first passes its tensors through the AMP hook
(`amp.cast_inputs`) under the name JAX's ``apply_op`` gives it: with
`amp.init` on, ``fully_connected`` runs in the AMP dtype, ``layer_norm``
in f32 and the others keep what arrives; with AMP off the hook changes
nothing.

`remat_call` and `resolve_remat_policy` port JAX's remat knob onto
``torch.utils.checkpoint``: the non-reentrant form (``TrainStep`` takes
gradients with ``torch.autograd.grad``) with JAX's named policies as
selective-checkpoint op lists, and the explicit dropout generators put
back for the recompute.
"""
from __future__ import annotations

import contextlib
import functools
import math
import os

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from .. import amp as _amp
from .. import autograd as _ag
from ..base import MXNetError

from . import fused_norm as _fnorm
from .softmax_xent import softmax_cross_entropy as _xent

__all__ = ["layer_norm", "layer_norm_residual", "rms_norm",
           "rms_norm_residual", "gelu", "dropout", "embedding",
           "fully_connected", "pick", "softmax_cross_entropy",
           "activation", "leaky_relu", "elu", "selu", "prelu", "silu",
           "log_softmax", "batch_norm", "group_norm", "instance_norm",
           "ctc_loss", "convolution", "deconvolution", "pooling",
           "resolve_remat_policy", "remat_call", "REMAT_POLICIES"]


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm (``npx.layer_norm``) over `axis`.  The last axis goes
    through `fused_norm.fused_layer_norm`: the fused row kernel's route
    when `fused_norm.kernel_eligible` (the policy), else
    `fused_norm.layer_norm_reference`, mean and variance in the input
    dtype.  Another axis takes that reference math, moved last."""
    x, gamma, beta = _amp.cast_inputs("layer_norm", x, gamma, beta)
    axis = axis % x.dim()
    if axis == x.dim() - 1:
        return _fnorm.fused_layer_norm(x, gamma, beta, eps=eps)
    y = _fnorm.layer_norm_reference(x.movedim(axis, -1), gamma, beta,
                                    eps=eps)
    return y.movedim(-1, axis)


def layer_norm_residual(x, residual, gamma, beta, axis=-1, eps=1e-5):
    """The pre-LN step ``s = residual + x; y = LN(s)``; returns ``(y, s)``
    (``npx.layer_norm_residual``).  Last axis only."""
    x, residual, gamma, beta = _amp.cast_inputs(
        "layer_norm_residual", x, residual, gamma, beta)
    _fnorm._last_axis("layer_norm_residual", x, axis)
    return _fnorm.layer_norm_residual(x, residual, gamma, beta, eps=eps)


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    """RMSNorm over the last axis: ``y = x * rsqrt(mean(x^2) + eps) *
    gamma`` (``npx.rms_norm``)."""
    x, gamma = _amp.cast_inputs("rms_norm", x, gamma)
    _fnorm._last_axis("rms_norm", x, axis)
    return _fnorm.fused_rms_norm(x, gamma, eps=eps)


def rms_norm_residual(x, residual, gamma, axis=-1, eps=1e-6):
    """``s = residual + x; y = RMSNorm(s)``; returns ``(y, s)``
    (``npx.rms_norm_residual``)."""
    x, residual, gamma = _amp.cast_inputs("rms_norm_residual", x, residual,
                                          gamma)
    _fnorm._last_axis("rms_norm_residual", x, axis)
    return _fnorm.rms_norm_residual(x, residual, gamma, eps=eps)


def gelu(x, approximation="erf"):
    """GELU; the erf form by default, as ``npx.gelu``.  ``"tanh"`` (or
    ``"fast"``) selects the tanh approximation."""
    (x,) = _amp.cast_inputs("gelu", x)
    if approximation in ("tanh", "fast"):
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def dropout(x, p=0.5, generator=None, training=True, axes=()):
    """Inverted dropout: keep each element with probability ``1 - p``
    (drawn from `generator`, the device's default when None) and scale it
    by ``1 / (1 - p)``; the mask is shared along `axes`.  Identity unless
    `training` and ``p > 0``."""
    if not training or p <= 0.0:
        return x
    (x,) = _amp.cast_inputs("dropout", x)
    shape = [1 if i in [a % x.dim() for a in axes] else n
             for i, n in enumerate(x.shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) \
        < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def embedding(ids, weight):
    """Row lookup; out-of-range ids clip to the table, as
    ``npx.embedding``'s ``mode="clip"`` does."""
    ids, weight = _amp.cast_inputs("embedding", ids, weight)
    idx = torch.as_tensor(ids, device=weight.device).long().clamp(
        0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


def fully_connected(x, weight, bias=None, flatten=False):
    """``x @ weight.T + bias`` (``npx.fully_connected``; weight (units,
    in_units)) in the promoted dtype of the operands; `flatten` first
    collapses every axis of `x` after the first."""
    x, weight, bias = _amp.cast_inputs("fully_connected", x, weight, bias)
    if flatten:
        x = x.reshape(x.shape[0], -1)
    dt = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        dt = torch.promote_types(dt, bias.dtype)
    return F.linear(x.to(dt), weight.to(dt),
                    None if bias is None else bias.to(dt))


def pick(x, index, axis=-1, keepdims=False):
    """``x`` at `index` along `axis`, indices clipped into range
    (``npx.pick``, mode "clip")."""
    x, index = _amp.cast_inputs("pick", x, index)
    axis = axis % x.dim()
    idx = torch.as_tensor(index, device=x.device).long().clamp(
        0, x.shape[axis] - 1).unsqueeze(axis)
    out = torch.gather(x, axis, idx)
    return out if keepdims else out.squeeze(axis)


def softmax_cross_entropy(logits, labels, reduction="none"):
    """Sparse-label cross entropy over the last axis
    (``npx.softmax_cross_entropy``): the streaming kernel on the card
    (`ops.softmax_xent`).  ``reduction="sum"`` gives the summed (1,)
    output of the reference op."""
    logits, labels = _amp.cast_inputs("softmax_cross_entropy", logits,
                                      labels)
    loss = _xent(logits, labels)
    if reduction == "sum":
        return loss.sum().reshape(1)
    return loss


# ---------------------------------------------------------------------------
# convolution and pooling (``npx.convolution`` / ``deconvolution`` /
# ``pooling``): no TPU kernel computes them; JAX runs
# ``lax.conv_general_dilated`` and ``lax.reduce_window``, the port torch's
# convolutions (cuDNN on the card) and pooling over a tensor it pads first
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _tuplize(v, n):
    """`v` (an int, a 1-tuple or an n-tuple) as an n-tuple."""
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(e) for e in v)
    return t * n if len(t) == 1 else t


def _promoted(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return [None if t is None else t.to(dt) for t in ts]


def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=0, num_group=1,
                no_bias=False, layout=None):
    """N-D convolution over NC(D)HW `data` with a (num_filter, in /
    num_group, *kernel) `weight` (``npx.convolution``): symmetric `pad`,
    `stride`, `dilate`, `num_group` groups; `kernel`, `num_filter` and
    `layout` are read from the weight and the input, as JAX does."""
    data, weight, bias = _amp.cast_inputs("convolution", data, weight,
                                          bias)
    nd = data.dim() - 2
    b = None if no_bias else bias
    data, weight, b = _promoted(data, weight, b)
    return _CONV[nd](data, weight, b, stride=_tuplize(stride or 1, nd),
                     padding=_tuplize(pad or 0, nd),
                     dilation=_tuplize(dilate or 1, nd), groups=num_group)


def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=0,
                  num_group=1, no_bias=True, layout=None,
                  target_shape=None):
    """Transposed convolution (``npx.deconvolution``), weight (in,
    num_filter / num_group, *kernel) as torch takes it: output size
    ``(in - 1) * stride - 2 * pad + dilate * (k - 1) + 1 + adj``.  The
    full transposed convolution is cropped to it (torch's own padding
    refuses an ``adj`` past the stride and the dilation, and a pad past
    the kernel's reach); outputs past the full one are zeros, then the
    bias.  `target_shape` is accepted and ignored, as in JAX."""
    data, weight, bias = _amp.cast_inputs("deconvolution", data, weight,
                                          bias)
    nd = data.dim() - 2
    stride = _tuplize(stride or 1, nd)
    dilate = _tuplize(dilate or 1, nd)
    pad = _tuplize(pad or 0, nd)
    adj = _tuplize(adj or 0, nd)
    b = None if no_bias else bias
    data, weight, b = _promoted(data, weight, b)
    full = _DECONV[nd](data, weight, None, stride=stride, groups=num_group,
                       dilation=dilate)
    grow, sl = [], [slice(None), slice(None)]
    for i, (a, p, s, d, k) in enumerate(zip(adj, pad, stride, dilate,
                                            weight.shape[2:])):
        grow = [0, max(0, a - p)] + grow
        n = (data.shape[2 + i] - 1) * s - 2 * p + d * (k - 1) + 1 + a
        sl.append(slice(p, p + n))
    out = (F.pad(full, grow) if any(grow) else full)[tuple(sl)]
    return out if b is None else out + b.reshape((-1,) + (1,) * nd)


def _window_sum(x, kernel, stride):
    """The sum of each window of `x` (no padding): an average with a
    divisor of one, 1-D windows through the 2-D call."""
    nd = x.dim() - 2
    if nd == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(2)
    fn = F.avg_pool2d if nd == 2 else F.avg_pool3d
    return fn(x, kernel, stride, divisor_override=1)


_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def pooling(data, kernel=None, stride=None, pad=None, pool_type="max",
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, p_value=2, layout=None):
    """Pooling over NC* `data` (``npx.pooling``): ``max``, ``avg``,
    ``sum`` and ``lp`` (``|x| ** p`` summed, then the p-th root), each
    global or windowed.  JAX's padding is applied first and the padded
    tensor pooled without torch's own: -inf for max (any pad), zeros
    otherwise; ``pooling_convention="full"`` pads the right further so the
    last window that starts inside fits (torch's ``ceil_mode`` would drop
    a window that starts in the padding); ``avg`` divides by the kernel's
    size with `count_include_pad` (the extra right padding too), else by
    the count of real elements.  A max window's gradient goes to its first
    largest element, as ``lax.reduce_window``'s does; a global max shares
    it among ties, as ``jnp.max``'s does."""
    (data,) = _amp.cast_inputs(
        "global_pool" if global_pool else {"max": "max_pool",
                                           "lp": "lp_pool"}.get(
            pool_type, "avg_pool"), data)
    nd = data.dim() - 2
    if global_pool:
        axes = tuple(range(2, 2 + nd))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        if pool_type == "avg":
            return data.mean(dim=axes, keepdim=True)
        return data.abs().pow(p_value).sum(dim=axes, keepdim=True).pow(
            1.0 / p_value)
    kernel = _tuplize(kernel, nd)
    stride = _tuplize(stride or 1, nd)
    pad = _tuplize(pad or 0, nd)
    right = list(pad)
    if pooling_convention == "full":
        for i in range(nd):
            size = data.shape[2 + i] + 2 * pad[i]
            out = math.ceil((size - kernel[i]) / stride[i]) + 1
            right[i] += max(0, (out - 1) * stride[i] + kernel[i] - size)
    widths = []
    for p, r in reversed(list(zip(pad, right))):
        widths += [p, r]
    if pool_type == "max":
        x = F.pad(data, widths, value=-math.inf) if any(widths) else data
        return _MAXPOOL[nd](x, kernel, stride)
    if pool_type not in ("avg", "sum", "lp"):
        raise MXNetError(f"unknown pool_type {pool_type}")
    x = data.abs().pow(p_value) if pool_type == "lp" else data
    s = _window_sum(F.pad(x, widths) if any(widths) else x, kernel, stride)
    if pool_type == "lp":
        return s.pow(1.0 / p_value)
    if pool_type == "sum":
        return s
    if count_include_pad:
        return s / float(math.prod(kernel))
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    cnt = _window_sum(F.pad(ones, widths) if any(widths) else ones, kernel,
                      stride)
    return s / cnt


# ---------------------------------------------------------------------------
# the Gluon layers' ops (``npx.activation`` and its family, the norms past
# LayerNorm, ``npx.ctc_loss``)
# ---------------------------------------------------------------------------

_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "log_sigmoid": F.logsigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
}
_SELU_SCALE = 1.0507009873554804934193349852946
_SELU_ALPHA = 1.6732632423543772848170429916717


def activation(x, act_type="relu"):
    """``npx.activation``: relu, sigmoid, log_sigmoid, tanh, softrelu
    (softplus), softsign or mish."""
    if act_type not in _ACTS:
        raise MXNetError(f"unknown activation {act_type!r}")
    (x,) = _amp.cast_inputs(act_type, x)
    return _ACTS[act_type](x)


def leaky_relu(x, slope=0.25):
    """``x`` where ``x >= 0``, else ``slope * x``."""
    (x,) = _amp.cast_inputs("leaky_relu", x)
    return torch.where(x >= 0, x, slope * x)


def elu(x, alpha=1.0):
    (x,) = _amp.cast_inputs("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x):
    """``scale * x`` where ``x >= 0``, else ``(scale * alpha) *
    expm1(x)``, the product of the constants rounded once (the
    reference's arithmetic)."""
    (x,) = _amp.cast_inputs("selu", x)
    return torch.where(x >= 0, _SELU_SCALE * x,
                       (_SELU_SCALE * _SELU_ALPHA) * torch.expm1(x))


def prelu(x, gamma):
    """Leaky ReLU with a learned slope, one a channel (axis 1)."""
    x, gamma = _amp.cast_inputs("prelu", x, gamma)
    if gamma.dim() == 1 and x.dim() > 1:
        gamma = gamma.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, gamma * x)


def silu(x):
    (x,) = _amp.cast_inputs("silu", x)
    return F.silu(x)


def log_softmax(x, axis=-1):
    (x,) = _amp.cast_inputs("log_softmax", x)
    return torch.log_softmax(x, dim=axis)


def _channel(v, x, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return v.reshape(shape)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               axis=1, training=False):
    """``npx.batch_norm``: in `training` (and not `use_global_stats`)
    the batch's mean and biased variance normalise `x`, and the running
    statistics move in place, MXNet's way: ``running = momentum * running
    + (1 - momentum) * batch`` (not ``F.batch_norm``'s complementary
    momentum and unbiased variance); otherwise the running statistics
    normalise.  ``fix_gamma`` uses a gain of ones."""
    x, gamma, beta = _amp.cast_inputs("batch_norm", x, gamma, beta)
    axis = axis % x.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training and not use_global_stats:
        red = tuple(i for i in range(x.dim()) if i != axis)
        mean = x.mean(dim=red)
        var = x.var(dim=red, correction=0)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean +
                               (1 - momentum) * mean.detach())
            running_var.copy_(momentum * running_var +
                              (1 - momentum) * var.detach())
    else:
        mean, var = running_mean, running_var
    y = (x - _channel(mean, x, axis)) * torch.rsqrt(
        _channel(var, x, axis) + eps)
    return y * _channel(g, x, axis) + _channel(beta, x, axis)


def group_norm(x, gamma, beta, num_groups=1, eps=1e-5):
    """``npx.group_norm`` over (N, C, ...): statistics per group of
    ``C / num_groups`` channels."""
    x, gamma, beta = _amp.cast_inputs("group_norm", x, gamma, beta)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = xg.var(dim=axes, keepdim=True, correction=0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * _channel(gamma, x, 1) + _channel(beta, x, 1)


def instance_norm(x, gamma, beta, eps=1e-5):
    """``npx.instance_norm`` over (N, C, ...): statistics per sample and
    channel."""
    x, gamma, beta = _amp.cast_inputs("instance_norm", x, gamma, beta)
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * _channel(gamma, x, 1) + _channel(beta, x, 1)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """``npx.ctc_loss``: the CTC negative log-likelihood of each sequence
    of `label` (B, L) under the pre-softmax scores `data` (T, B, C).  The
    blank is class 0 (``"first"``) or C - 1 (``"last"``); a label entry
    is padding where it is negative or, with `label_lengths`, at or past
    the sequence's length; `data_lengths` cut each sequence's frames.
    The JAX package computes it with ``optax.ctc_loss`` over
    ``log_softmax``; here ``F.ctc_loss`` over ``log_softmax`` (CTC has no
    TPU kernel), in f32, returned in `data`'s dtype."""
    (data,) = _amp.cast_inputs("ctc_loss", data)
    t, b, c = data.shape
    dev = data.device
    label = torch.as_tensor(label, device=dev).long()
    if use_data_lengths and data_lengths is not None:
        dl = torch.as_tensor(data_lengths, device=dev).long()
    else:
        dl = torch.full((b,), t, dtype=torch.long, device=dev)
    pos = torch.arange(label.shape[1], device=dev)
    if use_label_lengths and label_lengths is not None:
        ll = torch.as_tensor(label_lengths, device=dev).long()
        pad = pos[None, :] >= ll[:, None]
    else:
        pad = label < 0
    lengths = (~pad).sum(dim=1)
    blank = 0 if blank_label == "first" else c - 1
    targets = torch.where(pad, 0, label)
    logp = torch.log_softmax(data.float(), dim=-1)
    loss = F.ctc_loss(logp, targets, dl, lengths, blank=blank,
                      reduction="none", zero_infinity=False)
    return loss.to(data.dtype)


# ---------------------------------------------------------------------------
# remat (``npx.resolve_remat_policy`` / ``npx.remat_call``)
# ---------------------------------------------------------------------------

_DOTS = ("mm", "addmm", "bmm", "baddbmm")
# JAX's named `jax.checkpoint_policies` the port maps, to what a
# selective checkpoint saves: the outputs of these aten ops (None: save
# nothing, the whole call recomputes; "everything": save every residual,
# which is the call without remat)
REMAT_POLICIES = {
    "nothing_saveable": None,
    "everything_saveable": "everything",
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": ("mm", "addmm"),
    "checkpoint_dots_with_no_batch_dims": ("mm", "addmm"),
}


def resolve_remat_policy(value, env_override: bool = True):
    """Resolve a remat knob (``GPTConfig.remat``-style) to ``(enabled,
    policy)``, as ``npx.resolve_remat_policy`` reads it.

    ``False``/``None``/``"none"``/``"off"``/``"0"``/``"false"``/``"no"``
    turn remat off; ``True``/``"full"``/``"1"``/``"true"`` recompute the
    whole call (policy None); a name of `REMAT_POLICIES` (JAX's
    `jax.checkpoint_policies` names) is returned as the policy.  With
    `env_override` (the model-knob path) ``MXTPU_REMAT_POLICY`` wins over
    `value`.  Any other name raises `MXNetError` listing the names the
    port knows: a typo must not silently train without remat."""
    if env_override:
        env = os.environ.get("MXTPU_REMAT_POLICY", "").strip()
        if env:
            value = env
    if value is None or value is False:
        return False, None
    if value is True:
        return True, None
    name = str(value).strip().lower()
    if name in ("0", "off", "none", "false", "no"):
        return False, None
    if name in ("1", "true", "full"):
        return True, None
    if name not in REMAT_POLICIES:
        raise MXNetError(
            f"unknown remat policy {value!r}; expected 'none'/'full' or one "
            f"of the jax.checkpoint_policies names the port maps: "
            f"{sorted(REMAT_POLICIES)}")
    return True, name


def _generators_of(fn):
    """The explicit dropout generators a module call draws from."""
    from ..gluon.nn import Dropout
    if not isinstance(fn, torch.nn.Module):
        return []
    gens = {id(m.generator): m.generator for m in fn.modules()
            if isinstance(m, Dropout) and m.generator is not None}
    return list(gens.values())


def _generator_contexts(generators):
    """(forward, recompute) context managers for a checkpoint: the forward
    one snapshots each generator at entry; the recompute one puts those
    states back for the recompute and, on exit, returns each generator to
    where it was before the recompute (the first forward's end, or later
    calls' draws)."""
    snaps = []

    @contextlib.contextmanager
    def forward():
        snaps[:] = [g.get_state() for g in generators]
        yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in generators]
        for g, s in zip(generators, snaps):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(generators, now):
                g.set_state(s)

    return forward(), recompute()


def _mode_contexts():
    """(forward, recompute) context managers for a checkpoint: the
    recompute runs under the training flag (`autograd.is_training`) the
    forward saw, wherever the backward pass is called from."""
    seen = []

    @contextlib.contextmanager
    def forward():
        seen[:] = [_ag.is_training()]
        yield

    @contextlib.contextmanager
    def recompute():
        prev = _ag.set_training(seen[0])
        try:
            yield
        finally:
            _ag.set_training(prev)

    return forward(), recompute()


def _context_fn(policy, generators):
    gen_fwd, gen_rec = _generator_contexts(generators)
    mode_fwd, mode_rec = _mode_contexts()
    fwd, rec = _both(mode_fwd, gen_fwd), _both(mode_rec, gen_rec)
    saved = REMAT_POLICIES[policy] if policy is not None else None
    if saved is None:
        return fwd, rec
    ops = [getattr(torch.ops.aten, n).default for n in saved]
    sac_fwd, sac_rec = _ckpt.create_selective_checkpoint_contexts(ops)
    return _both(fwd, sac_fwd), _both(rec, sac_rec)


@contextlib.contextmanager
def _both(outer, inner):
    """Two context managers as one (the checkpoint takes one forward and
    one recompute context)."""
    with outer, inner:
        yield


def remat_call(fn, *args, policy=None):
    """Run ``fn(*args)`` under activation checkpointing: its activations
    are recomputed in the backward pass instead of stored
    (``npx.remat_call``, ``jax.checkpoint``).

    The non-reentrant ``torch.utils.checkpoint.checkpoint``, so gradients
    taken with ``torch.autograd.grad`` flow through it.  `policy` selects
    what is saved: None (save nothing), or a name of `REMAT_POLICIES` (an
    explicit string is taken literally; ``MXTPU_REMAT_POLICY`` applies to
    the model knob, not here).  ``"dots_saveable"`` saves the outputs of
    the matmul ops; the hand-written kernels are extension calls no policy
    saves, so they run again in the recompute.

    Dropout draws from explicit generators, which the checkpoint's own
    ``preserve_rng_state`` does not cover: when `fn` is a module, the state
    of each generator of the `Dropout` modules inside it (the attention
    draws its kernel seed from its output dropout's) is taken at entry and
    put back for the recompute, so the recompute draws the forward's masks
    and seeds; each generator is then left where the first forward left
    it.  The recompute also runs under the training flag the forward saw,
    so a Gluon block recomputed by a ``backward()`` outside ``record()``
    keeps its dropout."""
    if isinstance(policy, str):
        enabled, policy = resolve_remat_policy(policy, env_override=False)
        if not enabled:
            return fn(*args)
    if policy == "everything_saveable" or not torch.is_grad_enabled():
        return fn(*args)
    return _ckpt.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=True,
        context_fn=functools.partial(_context_fn, policy,
                                     _generators_of(fn)))
