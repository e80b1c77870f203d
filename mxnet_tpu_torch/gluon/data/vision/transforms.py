"""Vision transforms of the port (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``; parity:
`python/mxnet/gluon/data/vision/transforms.py`).

Transforms are Blocks operating on HWC images (like the reference): a
Block unwraps `mx.np` arrays, so each `forward` sees a torch tensor, and
the result comes back as an array on the input's device.  `ToTensor`
converts to CHW float32 scaled to [0, 1].  The transforms that resize,
crop or jitter colours call the image codec and augmenters (`mx.image`),
which are not ported yet: they raise `MXNetError` naming ROADMAP.md A11
part 2 when constructed.
"""
from __future__ import annotations

import numpy as _onp
import torch

from ....base import MXNetError
from ....ndarray.ndarray import to_torch_dtype
from ...block import Block, HybridBlock
from ...nn.basic_layers import Sequential

__all__ = ["Compose", "HybridCompose", "Cast", "ToTensor", "Normalize",
           "Resize", "CenterCrop", "RandomResizedCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "CropResize",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomColorJitter", "RandomLighting",
           "RandomGray", "RandomApply", "HybridRandomApply", "RandomCrop",
           "Rotate", "RandomRotation"]


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.to(to_torch_dtype(self._dtype))


_DIVISORS = {}


def _divisor(device):
    """255 as a 0-d float32 tensor on `device`: divided by a tensor, CUDA
    rounds the quotient as the CPU does (a Python scalar divisor becomes a
    product by its reciprocal there), so a batch made in a CPU worker
    equals one made on the card, bit for bit."""
    t = _DIVISORS.get(device)
    if t is None:
        t = _DIVISORS[device] = torch.tensor(255.0, device=device)
    return t


class ToTensor(HybridBlock):
    def forward(self, x):
        x = x.to(torch.float32) / _divisor(x.device)
        if x.dim() == 3:
            return x.permute(2, 0, 1)
        return x.permute(0, 3, 1, 2)


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def forward(self, x):
        shape = (-1, 1, 1) if x.dim() == 3 else (1, -1, 1, 1)

        def const(v):
            return torch.from_numpy(_onp.asarray(v, dtype=_onp.float32)
                                    .reshape(shape)).to(x.device)
        return (x - const(self._mean)) / const(self._std)


class RandomFlipLeftRight(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _onp.random.rand() < self._p:
            return torch.flip(x, dims=(1,))
        return x


class RandomFlipTopBottom(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _onp.random.rand() < self._p:
            return torch.flip(x, dims=(0,))
        return x


class CropResize(HybridBlock):
    """Crop the window (x, y, width, height); resizing it afterwards
    (`size`) needs the image codec (ROADMAP.md A11 part 2) and raises."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        if size:
            _no_codec("CropResize(size=...)")
        self._x, self._y = x, y
        self._w, self._h = width, height

    def forward(self, data):
        return data[self._y:self._y + self._h, self._x:self._x + self._w]


class RandomApply(Block):
    """Apply `transform` with probability p (ref transforms RandomApply)."""

    def __init__(self, transform, p=0.5):
        super().__init__()
        self._t = transform
        self.p = p

    def forward(self, x):
        if _onp.random.uniform() < self.p:
            return self._t(x)
        return x


def _rotate_hwc(x, deg, zoom_in=False, zoom_out=False):
    """Bilinear rotation of HWC tensor `x` about the center, same output
    size; zoom_out shrinks so every source pixel stays visible, zoom_in
    enlarges so no out-of-bounds padding shows.  The JAX package's
    ``_rotate_hwc`` step for step, in float32."""
    rad = float(_onp.deg2rad(deg))
    c, s = _onp.cos(rad), _onp.sin(rad)
    scale = 1.0
    if zoom_out or zoom_in:
        # factor by which the rotated bounding box exceeds the frame
        grow = abs(c) + abs(s)
        scale = grow if zoom_out else 1.0 / grow
    # JAX (64-bit off) takes these NumPy scalars as float32
    c, s = float(_onp.float32(c * scale)), float(_onp.float32(s * scale))
    if x.dim() != 3:
        raise MXNetError(
            f"Rotate expects a single HWC image (got ndim={x.dim()}); "
            f"apply before batching")
    h, w = x.shape[0], x.shape[1]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    f32 = dict(dtype=torch.float32, device=x.device)
    yy, xx = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32),
                            indexing="ij")
    ys = cy + (yy - cy) * c - (xx - cx) * s
    xs = cx + (yy - cy) * s + (xx - cx) * c
    y0 = torch.clamp(torch.floor(ys).to(torch.int32), 0, h - 1).long()
    x0 = torch.clamp(torch.floor(xs).to(torch.int32), 0, w - 1).long()
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[..., None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[..., None]
    xf = x.to(torch.float32)
    out = (xf[y0, x0] * (1 - wy) * (1 - wx) + xf[y1, x0] * wy * (1 - wx)
           + xf[y0, x1] * (1 - wy) * wx + xf[y1, x1] * wy * wx)
    valid = ((ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1))[..., None]
    return torch.where(valid, out, torch.zeros((), **f32)).to(x.dtype)


class Rotate(Block):
    """Rotate by a fixed angle in degrees (ref transforms Rotate).
    zoom_in/zoom_out rescale so no content (zoom_out) or no padding
    (zoom_in) appears, like the reference."""

    def __init__(self, rotation_degrees, zoom_in=False, zoom_out=False):
        super().__init__()
        if zoom_in and zoom_out:
            raise MXNetError("zoom_in and zoom_out are exclusive")
        self._deg = rotation_degrees
        self._zoom_in = zoom_in
        self._zoom_out = zoom_out

    def forward(self, x):
        return _rotate_hwc(x, self._deg, self._zoom_in, self._zoom_out)


class RandomRotation(Block):
    """Rotate by U(angle_limits) degrees (ref transforms RandomRotation)."""

    def __init__(self, angle_limits, zoom_in=False, zoom_out=False,
                 rotate_with_proba=1.0):
        super().__init__()
        if zoom_in and zoom_out:
            raise MXNetError("zoom_in and zoom_out are exclusive")
        self._limits = angle_limits
        self._zoom_in = zoom_in
        self._zoom_out = zoom_out
        self._p = rotate_with_proba

    def forward(self, x):
        if _onp.random.uniform() >= self._p:
            return x
        deg = float(_onp.random.uniform(*self._limits))
        return _rotate_hwc(x, deg, self._zoom_in, self._zoom_out)


def _no_codec(name):
    raise MXNetError(
        f"gluon.data.vision.transforms.{name} calls the image codec and "
        "augmenters (mx.image), which are not ported yet (ROADMAP.md A11 "
        "part 2)")


def _needs_codec(name):
    class _ImageTransform(Block):
        def __init__(self, *args, **kwargs):
            _no_codec(name)
    _ImageTransform.__name__ = _ImageTransform.__qualname__ = name
    _ImageTransform.__doc__ = ("Not ported yet: calls mx.image; raises "
                               "`MXNetError` (ROADMAP.md A11 part 2).")
    return _ImageTransform


Resize = _needs_codec("Resize")
CenterCrop = _needs_codec("CenterCrop")
RandomResizedCrop = _needs_codec("RandomResizedCrop")
RandomBrightness = _needs_codec("RandomBrightness")
RandomContrast = _needs_codec("RandomContrast")
RandomSaturation = _needs_codec("RandomSaturation")
RandomHue = _needs_codec("RandomHue")
RandomColorJitter = _needs_codec("RandomColorJitter")
RandomLighting = _needs_codec("RandomLighting")
RandomGray = _needs_codec("RandomGray")
RandomCrop = _needs_codec("RandomCrop")

# hybrid aliases (every transform here runs eagerly)
HybridCompose = Compose
HybridRandomApply = RandomApply
