"""Convolution and pooling Gluon layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``), NC(D)HW.

The convolutions hold their weight as a `Parameter` whose ``in_channels``
is deferred to the first input when 0 (``infer_shape``), and compute
through `ops.nn.convolution` / `deconvolution` (cuDNN on the card); the
pools through `ops.nn.pooling`.  As in JAX, a convolution stores
``layout`` and never reads it (an NHWC conv computes as NCHW), while a
pool with a channels-last layout moves the channels around the NC* op.
`DeformableConvolution` computes as JAX's does: its offset branch runs and
the regular convolution gives the output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from ...ops import nn as F
from ..block import HybridBlock
from ..parameter import Parameter
from .basic_layers import Activation

__all__ = [
    "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
    "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
    "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
    "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
    "GlobalAvgPool3D", "ReflectionPad2D", "PixelShuffle1D", "PixelShuffle2D",
    "PixelShuffle3D", "DeformableConvolution",
    "ModulatedDeformableConvolution",
]


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32", **kwargs):
        super().__init__(**kwargs)
        nd = len(kernel_size)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = kernel_size
        self._strides = _tup(strides, nd)
        self._padding = _tup(padding, nd)
        self._dilation = _tup(dilation, nd)
        self._groups = groups
        self._layout = layout
        self._activation = activation
        self.act = Activation(activation) if activation else None
        wshape = (channels, in_channels // groups if in_channels else 0) + \
            kernel_size
        self.weight = Parameter("weight", shape=wshape, dtype=dtype,
                                init=weight_initializer,
                                allow_deferred_init=not in_channels)
        self.bias = Parameter("bias", shape=(channels,), dtype=dtype,
                              init=bias_initializer) if use_bias else None

    def infer_shape(self, x, *args):
        c_in = x.shape[1]
        self._in_channels = c_in
        self.weight.shape = (self._channels, c_in // self._groups) + \
            self._kernel

    def _bias(self):
        return self.bias.data() if self.bias is not None else None

    def forward(self, x):
        out = F.convolution(
            x, self.weight.data(), self._bias(), stride=self._strides,
            dilate=self._dilation, pad=self._padding,
            num_group=self._groups, no_bias=self.bias is None)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        return (f"{type(self).__name__}({self._in_channels or None} -> "
                f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._strides})")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), strides, padding,
                         dilation, groups, layout, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), strides, padding,
                         dilation, groups, layout, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), strides, padding,
                         dilation, groups, layout, **kwargs)


class _ConvTranspose(_Conv):
    """Weight (in_channels, channels / groups, *kernel)."""

    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, in_channels=0,
                 **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels=in_channels, **kwargs)
        self._output_padding = _tup(output_padding, len(kernel_size))
        self.weight = Parameter("weight", shape=(in_channels or 0,
                                                 channels // groups) +
                                kernel_size,
                                dtype=kwargs.get("dtype", "float32"),
                                init=kwargs.get("weight_initializer"),
                                allow_deferred_init=not in_channels)

    def infer_shape(self, x, *args):
        c_in = x.shape[1]
        self._in_channels = c_in
        self.weight.shape = (c_in, self._channels // self._groups) + \
            self._kernel

    def forward(self, x):
        out = F.deconvolution(
            x, self.weight.data(), self._bias(), stride=self._strides,
            dilate=self._dilation, pad=self._padding,
            adj=self._output_padding, num_group=self._groups,
            no_bias=self.bias is None)
        return self.act(out) if self.act is not None else out


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), strides, padding,
                         output_padding, dilation, groups, layout, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), strides, padding,
                         output_padding, dilation, groups, layout, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), strides, padding,
                         output_padding, dilation, groups, layout, **kwargs)


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=True, **kwargs):
        super().__init__(**kwargs)
        self._kernel = pool_size
        self._stride = strides if strides is not None else pool_size
        self._pad = padding
        self._global = global_pool
        self._pool_type = pool_type
        self._convention = "full" if ceil_mode else "valid"
        self._count_include_pad = count_include_pad
        # NWC / NHWC / NDHWC: the channels move around the NC* op
        self._channels_last = bool(layout) and layout[-1] == "C"

    def forward(self, x):
        if self._channels_last:
            x = x.movedim(-1, 1)
        out = F.pooling(x, kernel=self._kernel, stride=self._stride,
                        pad=self._pad, pool_type=self._pool_type,
                        global_pool=self._global,
                        pooling_convention=self._convention,
                        count_include_pad=self._count_include_pad)
        return out.movedim(1, -1) if self._channels_last else out

    def __repr__(self):
        return (f"{type(self).__name__}(size={self._kernel}, "
                f"stride={self._stride}, padding={self._pad})")


def _pool_args(pool_size, strides, padding, n):
    return (_tup(pool_size, n), _tup(strides, n) if strides is not None
            else None, _tup(padding, n))


class MaxPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(*_pool_args(pool_size, strides, padding, 1),
                         ceil_mode, False, "max", layout, **kwargs)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(*_pool_args(pool_size, strides, padding, 2),
                         ceil_mode, False, "max", layout, **kwargs)


class MaxPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(*_pool_args(pool_size, strides, padding, 3),
                         ceil_mode, False, "max", layout, **kwargs)


class AvgPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(*_pool_args(pool_size, strides, padding, 1),
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(*_pool_args(pool_size, strides, padding, 2),
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class AvgPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(*_pool_args(pool_size, strides, padding, 3),
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class _GlobalPool(_Pool):
    def __init__(self, nd, pool_type, layout, **kwargs):
        super().__init__((1,) * nd, (1,) * nd, (0,) * nd, False, True,
                         pool_type, layout, **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "max", layout, **kwargs)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "max", layout, **kwargs)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "max", layout, **kwargs)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "avg", layout, **kwargs)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "avg", layout, **kwargs)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "avg", layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflect-pads the two last axes: `padding` an int, a (h, w) pair, or
    JAX's per-axis ``((before, after), ...)`` over all four axes."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        self._padding = _tup(padding, 2) if isinstance(padding, int) \
            else padding

    def forward(self, x):
        p = self._padding
        if isinstance(p, tuple) and len(p) == 2 and isinstance(p[0], int):
            pads = ((0, 0), (0, 0), (p[0], p[0]), (p[1], p[1]))
        else:
            pads = tuple(tuple(q) for q in p)
        widths = [w for q in reversed(pads[2:]) for w in q]
        if any(pads[0]) or any(pads[1]):
            raise ValueError("ReflectionPad2D pads the two spatial axes "
                             f"only, got {pads}")
        return _F.pad(x, widths, mode="reflect")


class _PixelShuffle(HybridBlock):
    def __init__(self, factor, nd, **kwargs):
        super().__init__(**kwargs)
        self._factor = _tup(factor, nd)
        self._nd = nd

    def forward(self, x):
        f = self._factor
        nd = self._nd
        b, c = x.shape[:2]
        sp = tuple(x.shape[2:])
        x = x.reshape((b, c // torch.Size(f).numel()) + f + sp)
        # (b, c, f1..fn, s1..sn) -> (b, c, s1, f1, ..., sn, fn)
        order = [0, 1] + [a for i in range(nd) for a in (2 + nd + i, 2 + i)]
        return x.permute(order).reshape(
            (b, c // torch.Size(f).numel()) +
            tuple(s * k for s, k in zip(sp, f)))


class PixelShuffle1D(_PixelShuffle):
    def __init__(self, factor, **kwargs):
        super().__init__(factor, 1, **kwargs)


class PixelShuffle2D(_PixelShuffle):
    def __init__(self, factor, **kwargs):
        super().__init__(factor, 2, **kwargs)


class PixelShuffle3D(_PixelShuffle):
    def __init__(self, factor, **kwargs):
        super().__init__(factor, 3, **kwargs)


class DeformableConvolution(HybridBlock):
    """Deformable convolution as the JAX package's block computes it: an
    offset convolution (``offset_conv``) and the regular convolution
    (``conv``) over the input; the offsets are computed, and the output is
    the regular convolution's (ROADMAP.md §C caveat).  The sampling op
    itself is `npx.deformable_convolution`."""

    def __init__(self, channels, kernel_size=(3, 3), strides=(1, 1),
                 padding=(1, 1), dilation=(1, 1), groups=1,
                 num_deformable_group=1, in_channels=0, use_bias=True,
                 **kwargs):
        super().__init__(**kwargs)
        kernel_size = _tup(kernel_size, 2)
        self._offset_conv = Conv2D(
            2 * kernel_size[0] * kernel_size[1] * num_deformable_group,
            kernel_size, strides, padding, dilation,
            in_channels=in_channels, use_bias=use_bias)
        self._conv = Conv2D(channels, kernel_size, strides, padding,
                            dilation, groups, in_channels=in_channels,
                            use_bias=use_bias)
        self.register_child(self._offset_conv, "offset_conv")
        self.register_child(self._conv, "conv")

    def forward(self, x):
        self._offset_conv(x)
        return self._conv(x)


class ModulatedDeformableConvolution(DeformableConvolution):
    pass
