"""Port parity: the convolution and pooling layers of `gluon.nn`
(`mxnet_tpu_torch.gluon.nn.conv_layers`) against the JAX package's on the
CPU.

Each layer is built in both packages, the JAX one initialised and called
once (its shapes are deferred), its parameters carried into the port's
by name (`load_jax_params`), and both run one recorded forward and
backward of ``sum(out ** 2)``: the outputs, the input's gradient and every
parameter's gradient are compared.  Covered: Conv1D/2D/3D with stride,
dilation, padding, groups, ``activation=`` and no bias; an NHWC layout
(stored and not read, as in JAX: the conv computes as NCHW); the
transposed forms with ``output_padding``; max and average pools with
``ceil_mode`` and ``count_include_pad``, channels-last layouts, the global
pools; ReflectionPad2D; PixelShuffle1D/2D/3D; the deformable blocks.
Deferred ``in_channels`` and the parameter names are checked on their
own.  Tolerances: values rtol 1e-4 / atol 1e-5, gradients rtol and atol
1e-4 (f32).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tm
from mxnet_tpu_torch import load_jax_params
from mxnet_tpu_torch.gluon import nn as tnn

torch.set_num_threads(1)

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)

# name -> (layer(nn), input shape)
LAYERS = {
    "conv1d": (lambda nn: nn.Conv1D(4, 3, strides=2, padding=1, dilation=2,
                                    activation="relu"), (2, 3, 11)),
    "conv2d_groups_no_bias": (lambda nn: nn.Conv2D(
        6, (3, 2), strides=(2, 1), padding=(1, 1), groups=2,
        use_bias=False), (2, 4, 7, 8)),
    "conv2d_nhwc_layout": (lambda nn: nn.Conv2D(4, 3, padding=1,
                                                layout="NHWC"),
                           (2, 3, 5, 6)),
    "conv3d": (lambda nn: nn.Conv3D(3, 2, padding=1, activation="tanh"),
               (1, 2, 4, 5, 4)),
    "conv1d_transpose": (lambda nn: nn.Conv1DTranspose(
        3, 4, strides=2, padding=1, output_padding=1), (2, 4, 7)),
    "conv2d_transpose_groups": (lambda nn: nn.Conv2DTranspose(
        4, (3, 2), strides=(2, 3), padding=(1, 0), output_padding=(1, 2),
        groups=2), (2, 4, 5, 6)),
    "conv3d_transpose": (lambda nn: nn.Conv3DTranspose(2, 2, strides=2),
                         (1, 2, 3, 4, 3)),
    "maxpool1d": (lambda nn: nn.MaxPool1D(3, 2, 1), (2, 3, 10)),
    "maxpool2d_ceil": (lambda nn: nn.MaxPool2D(3, 2, 1, ceil_mode=True),
                       (2, 3, 8, 9)),
    "maxpool3d": (lambda nn: nn.MaxPool3D(2), (1, 2, 4, 6, 4)),
    "avgpool1d_real_count": (lambda nn: nn.AvgPool1D(
        3, 2, 1, count_include_pad=False), (2, 3, 10)),
    "avgpool2d_ceil": (lambda nn: nn.AvgPool2D(2, ceil_mode=True),
                       (2, 3, 7, 9)),
    "avgpool3d": (lambda nn: nn.AvgPool3D((2, 2, 1)), (1, 2, 4, 6, 4)),
    "maxpool1d_nwc": (lambda nn: nn.MaxPool1D(2, layout="NWC"), (2, 8, 3)),
    "maxpool2d_nhwc": (lambda nn: nn.MaxPool2D(3, 2, 1, layout="NHWC",
                                               ceil_mode=True),
                       (2, 7, 7, 3)),
    "avgpool3d_ndhwc": (lambda nn: nn.AvgPool3D(2, layout="NDHWC"),
                        (1, 4, 4, 6, 2)),
    "global_max1d": (lambda nn: nn.GlobalMaxPool1D(), (2, 3, 7)),
    "global_max2d": (lambda nn: nn.GlobalMaxPool2D(), (2, 3, 5, 6)),
    "global_max3d": (lambda nn: nn.GlobalMaxPool3D(), (1, 2, 3, 4, 3)),
    "global_avg1d": (lambda nn: nn.GlobalAvgPool1D(), (2, 3, 7)),
    "global_avg2d_nhwc": (lambda nn: nn.GlobalAvgPool2D(layout="NHWC"),
                          (2, 5, 6, 3)),
    "global_avg3d": (lambda nn: nn.GlobalAvgPool3D(), (1, 2, 3, 4, 3)),
    "reflection_pad": (lambda nn: nn.ReflectionPad2D(2), (2, 3, 5, 6)),
    "reflection_pad_widths": (lambda nn: nn.ReflectionPad2D(
        ((0, 0), (0, 0), (1, 2), (2, 1))), (2, 3, 5, 6)),
    "pixel_shuffle1d": (lambda nn: nn.PixelShuffle1D(3), (2, 6, 4)),
    "pixel_shuffle2d": (lambda nn: nn.PixelShuffle2D((2, 3)),
                        (2, 12, 3, 4)),
    "pixel_shuffle3d": (lambda nn: nn.PixelShuffle3D(2), (1, 16, 2, 3, 2)),
    "deformable": (lambda nn: nn.DeformableConvolution(4), (2, 3, 6, 6)),
    "modulated_deformable": (lambda nn: nn.ModulatedDeformableConvolution(
        3, kernel_size=(3, 3), num_deformable_group=2, use_bias=False),
        (2, 4, 5, 5)),
}


def _x(name):
    seed = sorted(LAYERS).index(name)
    return np.random.RandomState(seed).uniform(
        -1, 1, LAYERS[name][1]).astype(np.float32)


def _jax_side(name):
    mx.random.seed(3)
    net = LAYERS[name][0](jnn)
    net.initialize(mx.init.Normal(0.5))
    x = mx.np.array(_x(name))
    net(x)
    x.attach_grad()
    with mx.autograd.record():
        y = net(x)
        head = (y * y).sum()
    head.backward()
    params = net.collect_params()
    return (y.asnumpy(), x.grad.asnumpy(),
            {k: p.data().asnumpy() for k, p in params.items()},
            {k: p.grad().asnumpy() for k, p in params.items()})


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    y, xg, params, pgrads = _jax_side(name)
    net = LAYERS[name][0](tnn)
    assert list(net.collect_params()) == list(params)
    load_jax_params(net, params, device="cpu")
    with tm.cpu():
        x = tm.np.array(_x(name))
        x.attach_grad()
        with tm.autograd.record():
            out = net(x)
            head = (out * out).sum()
        head.backward()
    np.testing.assert_allclose(out.asnumpy(), y, **VAL)
    np.testing.assert_allclose(x.grad.asnumpy(), xg, **GRAD)
    for k, p in net.collect_params().items():
        np.testing.assert_allclose(p.grad().numpy(), pgrads[k], err_msg=k,
                                   **GRAD)


def test_in_channels_are_deferred_to_the_first_call():
    conv = tnn.Conv2D(5, 3, groups=1)
    deconv = tnn.Conv2DTranspose(6, (2, 3), groups=2)
    fixed = tnn.Conv2D(5, 3, in_channels=4)
    assert conv.weight.shape == (5, 0, 3, 3)
    assert deconv.weight.shape == (0, 3, 2, 3)
    assert fixed.weight.shape == (5, 4, 3, 3)
    for layer in (conv, deconv, fixed):
        layer.initialize(device="cpu")
    assert conv.weight._data is None and fixed.weight._data is not None
    x = torch.zeros(1, 4, 6, 6)
    assert conv(x).shape == (1, 5, 4, 4)
    assert deconv(x).shape == (1, 6, 7, 8)
    assert conv.weight.shape == (5, 4, 3, 3)
    assert deconv.weight.shape == (4, 3, 2, 3)
    assert "4 -> 5" in repr(conv)


def test_zoo_style_nets_defer_every_shape_before_the_trainer():
    """A net built with ``in_channels=0`` everywhere has every shape after
    one call, so a `Trainer` made then sees every parameter."""
    net = tnn.HybridSequential()
    net.add(tnn.Conv2D(4, 3, padding=1), tnn.BatchNorm(),
            tnn.Activation("relu"), tnn.MaxPool2D(), tnn.Conv2D(8, 3),
            tnn.GlobalAvgPool2D(), tnn.Dense(3))
    net.initialize(tm.init.Xavier(), device="cpu")
    assert all(p._data is None for k, p in net.collect_params().items()
               if k.endswith("weight") or k.startswith("1."))
    net(torch.zeros(2, 3, 8, 8))
    shapes = {k: tuple(p.shape) for k, p in net.collect_params().items()}
    assert shapes["0.weight"] == (4, 3, 3, 3)
    assert shapes["4.weight"] == (8, 4, 3, 3)
    assert shapes["6.weight"] == (3, 8)
    trainer = tm.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    assert len(trainer._params) == sum(
        p.grad_req != "null" for p in net.collect_params().values())


@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
def test_xavier_on_a_conv_weight_has_jax_scale(factor_type):
    """Xavier on a 4-D weight takes ``fan_in = shape[1] * prod(kernel)``
    and ``fan_out = shape[0] * prod(kernel)``, as JAX's does: both
    packages' draws fill the same interval (uniform) or have its standard
    deviation (gaussian)."""
    shape = (64, 32, 3, 3)
    fans = {"in": 32 * 9, "out": 64 * 9, "avg": (32 * 9 + 64 * 9) / 2}
    scale = np.sqrt(3.0 / fans[factor_type])
    for rnd in ("uniform", "gaussian"):
        jconv = jnn.Conv2D(64, 3, in_channels=32)
        jconv.initialize(mx.init.Xavier(rnd, factor_type))
        tconv = tnn.Conv2D(64, 3, in_channels=32)
        tconv.initialize(tm.init.Xavier(rnd, factor_type), device="cpu")
        for w in (jconv.weight.data().asnumpy(),
                  tconv.weight.data().detach().numpy()):
            assert w.shape == shape
            if rnd == "uniform":
                assert np.abs(w).max() <= scale
                assert np.abs(w).max() > 0.99 * scale
            else:
                np.testing.assert_allclose(w.std(), scale, rtol=0.03)
