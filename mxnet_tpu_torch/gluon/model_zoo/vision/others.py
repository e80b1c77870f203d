"""AlexNet, VGG (with and without BatchNorm), SqueezeNet 1.0 / 1.1,
MobileNet v1 and v2, DenseNet and Inception-v3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/others.py``): the same blocks, the
same parameter names, built with random weights (`pretrained` loads
weights placed under `root`; nothing is downloaded)."""
from __future__ import annotations

import torch

from ... import nn
from ...block import HybridBlock

__all__ = ["AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "SqueezeNet",
           "squeezenet1_0", "squeezenet1_1", "MobileNet", "MobileNetV2",
           "mobilenet1_0", "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
           "mobilenet_v2_1_0", "mobilenet_v2_0_75", "mobilenet_v2_0_5",
           "mobilenet_v2_0_25", "DenseNet", "densenet121", "densenet161",
           "densenet169", "densenet201", "Inception3", "inception_v3"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(64, 11, 4, 2, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Conv2D(192, 5, padding=2, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Conv2D(384, 3, padding=1, activation="relu"))
        self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
        self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, root=None, **kwargs):
    return _pretrained(AlexNet(**_model_kwargs(kwargs)),
                       pretrained, "alexnet", root)


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        self.features = nn.HybridSequential()
        for i, num in enumerate(layers):
            for _ in range(num):
                self.features.add(nn.Conv2D(filters[i], kernel_size=3,
                                            padding=1))
                if batch_norm:
                    self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(strides=2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


_vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
             13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
             16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
             19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def _vgg(num_layers, batch_norm=False, pretrained=False, root=None,
         **kwargs):
    layers, filters = _vgg_spec[num_layers]
    net = VGG(layers, filters, batch_norm=batch_norm,
              **_model_kwargs(kwargs))
    name = f"vgg{num_layers}" + ("_bn" if batch_norm else "")
    return _pretrained(net, pretrained, name, root)


def vgg11(**kw):
    return _vgg(11, **kw)


def vgg13(**kw):
    return _vgg(13, **kw)


def vgg16(**kw):
    return _vgg(16, **kw)


def vgg19(**kw):
    return _vgg(19, **kw)


def vgg11_bn(**kw):
    return _vgg(11, batch_norm=True, **kw)


def vgg13_bn(**kw):
    return _vgg(13, batch_norm=True, **kw)


def vgg16_bn(**kw):
    return _vgg(16, batch_norm=True, **kw)


def vgg19_bn(**kw):
    return _vgg(19, batch_norm=True, **kw)


class _Fire(HybridBlock):
    def __init__(self, squeeze, expand1x1, expand3x3, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = nn.Conv2D(squeeze, kernel_size=1, activation="relu")
        self.expand1x1 = nn.Conv2D(expand1x1, kernel_size=1,
                                   activation="relu")
        self.expand3x3 = nn.Conv2D(expand3x3, kernel_size=3, padding=1,
                                   activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return torch.cat([self.expand1x1(x), self.expand3x3(x)], dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version="1.0", classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(nn.Conv2D(96, 7, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(64, 256, 256))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(64, 256, 256))
        else:
            self.features.add(nn.Conv2D(64, 3, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(64, 256, 256))
            self.features.add(_Fire(64, 256, 256))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, kernel_size=1, activation="relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, root=None, **kw):
    return _pretrained(SqueezeNet("1.0", **_model_kwargs(kw)),
                       pretrained, "squeezenet1.0", root)


def squeezenet1_1(pretrained=False, root=None, **kw):
    return _pretrained(SqueezeNet("1.1", **_model_kwargs(kw)),
                       pretrained, "squeezenet1.1", root)


def _conv_block(channels, kernel=1, stride=1, pad=0, num_group=1):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    return out


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        dw_channels = [int(x * multiplier) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
        channels = [int(x * multiplier) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
        strides = [1, 2] * 3 + [1] * 5 + [2, 1]
        self.features = nn.HybridSequential()
        self.features.add(_conv_block(int(32 * multiplier), 3, 2, 1))
        for dwc, c, s in zip(dw_channels, channels, strides):
            self.features.add(_conv_block(dwc, 3, s, 1, num_group=dwc))
            self.features.add(_conv_block(c, 1))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class _LinearBottleneck(HybridBlock):
    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = nn.HybridSequential()
        self.out.add(_conv_block(in_channels * t, 1))
        self.out.add(_conv_block(in_channels * t, 3, stride, 1,
                                 num_group=in_channels * t))
        self.out.add(nn.Conv2D(channels, 1, use_bias=False))
        self.out.add(nn.BatchNorm())

    def forward(self, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(_conv_block(int(32 * multiplier), 3, 2, 1))
        in_c = [int(multiplier * x) for x in
                [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3 +
                [160] * 3]
        c = [int(multiplier * x) for x in
             [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3 + [160] * 3 +
             [320]]
        t = [1] + [6] * 16
        s = [1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1]
        for ic, oc, ti, si in zip(in_c, c, t, s):
            self.features.add(_LinearBottleneck(ic, oc, ti, si))
        last = int(1280 * multiplier) if multiplier > 1.0 else 1280
        self.features.add(_conv_block(last, 1))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, 1, use_bias=False))
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def _mobilenet(mult, pretrained=False, root=None, **kw):
    return _pretrained(MobileNet(mult, **_model_kwargs(kw)),
                       pretrained, f"mobilenet{mult}", root)


def _mobilenet_v2(mult, pretrained=False, root=None, **kw):
    return _pretrained(MobileNetV2(mult, **_model_kwargs(kw)),
                       pretrained, f"mobilenetv2_{mult}", root)


def mobilenet1_0(**kw):
    return _mobilenet(1.0, **kw)


def mobilenet0_75(**kw):
    return _mobilenet(0.75, **kw)


def mobilenet0_5(**kw):
    return _mobilenet(0.5, **kw)


def mobilenet0_25(**kw):
    return _mobilenet(0.25, **kw)


def mobilenet_v2_1_0(**kw):
    return _mobilenet_v2(1.0, **kw)


def mobilenet_v2_0_75(**kw):
    return _mobilenet_v2(0.75, **kw)


def mobilenet_v2_0_5(**kw):
    return _mobilenet_v2(0.5, **kw)


def mobilenet_v2_0_25(**kw):
    return _mobilenet_v2(0.25, **kw)


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                                use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def forward(self, x):
        out = self.body(x)
        return torch.cat([x, out], dim=1)


def _make_transition(num_out):
    out = nn.HybridSequential()
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_out, kernel_size=1, use_bias=False))
    out.add(nn.AvgPool2D(2, 2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(num_init_features, 7, 2, 3,
                                    use_bias=False))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(3, 2, 1))
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            block = nn.HybridSequential()
            for _ in range(num_layers):
                block.add(_DenseLayer(growth_rate, bn_size, dropout))
            self.features.add(block)
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                self.features.add(_make_transition(num_features // 2))
                num_features //= 2
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


_densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                  161: (96, 48, [6, 12, 36, 24]),
                  169: (64, 32, [6, 12, 32, 32]),
                  201: (64, 32, [6, 12, 48, 32])}


def _densenet(num_layers, pretrained=False, root=None, **kw):
    init_f, growth, cfg = _densenet_spec[num_layers]
    return _pretrained(DenseNet(init_f, growth, cfg, **_model_kwargs(kw)),
                       pretrained, f"densenet{num_layers}", root)


def densenet121(**kw):
    return _densenet(121, **kw)


def densenet161(**kw):
    return _densenet(161, **kw)


def densenet169(**kw):
    return _densenet(169, **kw)


def densenet201(**kw):
    return _densenet(201, **kw)


def _inc_conv(channels, kernel_size, strides=1, padding=0):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel_size, strides, padding,
                      use_bias=False))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _InceptionConcat(HybridBlock):
    def __init__(self, *branches, **kwargs):
        super().__init__(**kwargs)
        for i, b in enumerate(branches):
            self.register_child(b, f"branch{i}")

    def forward(self, x):
        return torch.cat([b(x) for b in self._child_blocks()], dim=1)


def _make_A(pool_features):
    b1 = _inc_conv(64, 1)
    b2 = nn.HybridSequential()
    b2.add(_inc_conv(48, 1))
    b2.add(_inc_conv(64, 5, padding=2))
    b3 = nn.HybridSequential()
    b3.add(_inc_conv(64, 1))
    b3.add(_inc_conv(96, 3, padding=1))
    b3.add(_inc_conv(96, 3, padding=1))
    b4 = nn.HybridSequential()
    b4.add(nn.AvgPool2D(3, 1, 1))
    b4.add(_inc_conv(pool_features, 1))
    return _InceptionConcat(b1, b2, b3, b4)


def _make_B():
    b1 = _inc_conv(384, 3, 2)
    b2 = nn.HybridSequential()
    b2.add(_inc_conv(64, 1))
    b2.add(_inc_conv(96, 3, padding=1))
    b2.add(_inc_conv(96, 3, 2))
    b3 = nn.MaxPool2D(3, 2)
    return _InceptionConcat(b1, b2, b3)


def _make_C(channels_7x7):
    b1 = _inc_conv(192, 1)
    b2 = nn.HybridSequential()
    b2.add(_inc_conv(channels_7x7, 1))
    b2.add(_inc_conv(channels_7x7, (1, 7), padding=(0, 3)))
    b2.add(_inc_conv(192, (7, 1), padding=(3, 0)))
    b3 = nn.HybridSequential()
    b3.add(_inc_conv(channels_7x7, 1))
    b3.add(_inc_conv(channels_7x7, (7, 1), padding=(3, 0)))
    b3.add(_inc_conv(channels_7x7, (1, 7), padding=(0, 3)))
    b3.add(_inc_conv(channels_7x7, (7, 1), padding=(3, 0)))
    b3.add(_inc_conv(192, (1, 7), padding=(0, 3)))
    b4 = nn.HybridSequential()
    b4.add(nn.AvgPool2D(3, 1, 1))
    b4.add(_inc_conv(192, 1))
    return _InceptionConcat(b1, b2, b3, b4)


def _make_D():
    b1 = nn.HybridSequential()
    b1.add(_inc_conv(192, 1))
    b1.add(_inc_conv(320, 3, 2))
    b2 = nn.HybridSequential()
    b2.add(_inc_conv(192, 1))
    b2.add(_inc_conv(192, (1, 7), padding=(0, 3)))
    b2.add(_inc_conv(192, (7, 1), padding=(3, 0)))
    b2.add(_inc_conv(192, 3, 2))
    b3 = nn.MaxPool2D(3, 2)
    return _InceptionConcat(b1, b2, b3)


class _SplitConcat(HybridBlock):
    def __init__(self, head, tail_a, tail_b, **kwargs):
        super().__init__(**kwargs)
        self.head = head
        self.tail_a = tail_a
        self.tail_b = tail_b

    def forward(self, x):
        y = self.head(x)
        return torch.cat([self.tail_a(y), self.tail_b(y)], dim=1)


def _make_E():
    b1 = _inc_conv(320, 1)
    b2 = _SplitConcat(_inc_conv(384, 1),
                      _inc_conv(384, (1, 3), padding=(0, 1)),
                      _inc_conv(384, (3, 1), padding=(1, 0)))
    b3_head = nn.HybridSequential()
    b3_head.add(_inc_conv(448, 1))
    b3_head.add(_inc_conv(384, 3, padding=1))
    b3 = _SplitConcat(b3_head,
                      _inc_conv(384, (1, 3), padding=(0, 1)),
                      _inc_conv(384, (3, 1), padding=(1, 0)))
    b4 = nn.HybridSequential()
    b4.add(nn.AvgPool2D(3, 1, 1))
    b4.add(_inc_conv(192, 1))
    return _InceptionConcat(b1, b2, b3, b4)


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(_inc_conv(32, 3, 2))
        self.features.add(_inc_conv(32, 3))
        self.features.add(_inc_conv(64, 3, padding=1))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(_inc_conv(80, 1))
        self.features.add(_inc_conv(192, 3))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_make_E())
        self.features.add(_make_E())
        self.features.add(nn.AvgPool2D(8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, root=None, **kw):
    return _pretrained(Inception3(**_model_kwargs(kw)),
                       pretrained, "inceptionv3", root)


def _pretrained(net, pretrained, name, root):
    """`net`, with the weights placed under `root` when `pretrained`
    (`model_store.load_pretrained`)."""
    from ..model_store import load_pretrained
    return load_pretrained(net, pretrained, name, root)


def _model_kwargs(kw):
    kw.pop("device", None)
    kw.pop("ctx", None)
    kw.pop("root", None)
    return kw
