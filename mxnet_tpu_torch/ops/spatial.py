"""Spatial, warping and matching operators in plain torch (counterpart of
``mxnet_tpu/ops/spatial.py``): ``GridGenerator``, ``BilinearSampler``,
``SpatialTransformer``, ``Correlation``, ``im2col`` / ``col2im`` and
deformable convolution v1.  No TPU kernel computes them; the JAX package
writes them in jnp / lax, and autograd gives the gradients in both.

Conventions, JAX's:
- sampling grids are normalised to [-1, 1] with align-corners semantics
  (grid -1 is pixel 0, +1 pixel N-1);
- a bilinear tap outside the image counts zero, and the in-range taps of a
  partly outside sample are kept (`bilinear_gather`, a gather of the four
  taps; ``F.grid_sample``'s ``padding_mode="zeros"`` would do the same,
  but its index rounding is its own);
- `col2im` is the adjoint of `im2col` (``F.fold`` of ``F.unfold``);
- deformable convolution is one bilinear gather a kernel tap, then one
  product a tap, as JAX builds it.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "bilinear_gather", "bilinear_sample", "grid_generator",
    "spatial_transformer", "correlation", "im2col", "col2im",
    "deformable_convolution",
]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def bilinear_gather(data, x, y):
    """Bilinear sample `data` (B, C, H, W) at pixel coordinates `x` / `y`
    (B, Ho, Wo): the four taps, each zero where it falls outside
    [0, W-1] x [0, H-1]."""
    B, C, H, W = data.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    flat = data.reshape(B, C, H * W)

    def tap(xi, yi, w):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = xi.clamp(0, W - 1).long()
        yc = yi.clamp(0, H - 1).long()
        idx = (yc * W + xc).reshape(B, 1, -1).expand(B, C, -1)
        v = torch.gather(flat, 2, idx).reshape((B, C) + tuple(x.shape[1:]))
        return v * (w * valid).unsqueeze(1).to(data.dtype)

    wx1 = x - x0
    wy1 = y - y0
    return (tap(x0, y0, (1 - wx1) * (1 - wy1))
            + tap(x0 + 1, y0, wx1 * (1 - wy1))
            + tap(x0, y0 + 1, (1 - wx1) * wy1)
            + tap(x0 + 1, y0 + 1, wx1 * wy1))


def bilinear_sample(data, grid):
    """BilinearSampler: `grid` (B, 2, Ho, Wo) holds normalised (x, y) in
    [-1, 1]; returns (B, C, Ho, Wo)."""
    _, _, H, W = data.shape
    x = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    y = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    return bilinear_gather(data, x, y)


def grid_generator(data, transform_type: str = "affine",
                   target_shape: Sequence[int] = (0, 0)):
    """GridGenerator -> (B, 2, H, W) normalised sampling grid.  affine:
    `data` (B, 6) is a row-major 2x3 theta mapping target (x_t, y_t, 1) to
    source (x_s, y_s); warp: `data` (B, 2, H, W) is a pixel-offset flow
    added to the identity grid."""
    if transform_type == "affine":
        H, W = int(target_shape[0]), int(target_shape[1])
        if H <= 0 or W <= 0:
            raise ValueError(
                f"affine grid_generator needs a positive target_shape, got "
                f"{tuple(target_shape)} (the reference operator errors at "
                "shape inference too)")
        B = data.shape[0]
        theta = data.reshape(B, 2, 3).float()
        xt = torch.linspace(-1.0, 1.0, W, device=data.device)
        yt = torch.linspace(-1.0, 1.0, H, device=data.device)
        yg, xg = torch.meshgrid(yt, xt, indexing="ij")
        tgt = torch.stack([xg, yg, torch.ones_like(xg)]).reshape(3, H * W)
        src = torch.einsum("bij,jk->bik", theta, tgt)
        return src.reshape(B, 2, H, W).to(data.dtype)
    if transform_type == "warp":
        B, _, H, W = data.shape
        yy, xx = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=data.device),
            torch.arange(W, dtype=torch.float32, device=data.device),
            indexing="ij")
        x = xx[None] + data[:, 0].float()
        y = yy[None] + data[:, 1].float()
        xn = 2.0 * x / max(W - 1, 1) - 1.0
        yn = 2.0 * y / max(H - 1, 1) - 1.0
        return torch.stack([xn, yn], dim=1).to(data.dtype)
    raise ValueError(f"unknown transform_type {transform_type!r}")


def spatial_transformer(data, loc, target_shape=None,
                        transform_type: str = "affine",
                        sampler_type: str = "bilinear"):
    """SpatialTransformer: the affine grid of `loc` (B, 6) sampled
    bilinearly from `data` (B, C, H, W) at `target_shape` (Ho, Wo; the
    input's size when None or 0)."""
    if transform_type != "affine":
        raise ValueError("only affine SpatialTransformer is defined "
                         "(reference: spatial_transformer.cc)")
    if sampler_type != "bilinear":
        raise ValueError("only bilinear sampling is defined")
    if target_shape is None or tuple(target_shape)[-1] == 0:
        target_shape = tuple(data.shape[2:])
    return bilinear_sample(data, grid_generator(loc, "affine",
                                                target_shape))


def correlation(data1, data2, kernel_size: int = 1,
                max_displacement: int = 1, stride1: int = 1,
                stride2: int = 1, pad_size: int = 0,
                is_multiply: bool = True):
    """FlowNet correlation cost volume: (B, D*D, Ho, Wo) with D =
    2 * (max_displacement // stride2) + 1; channel d is the displacement
    (dy, dx) = stride2 * (d // D - bd, d % D - bd), each entry the mean
    over channels and the kernel window of ``data1[x] * data2[x + disp]``
    (``|a - b|`` when not `is_multiply`)."""
    B, C, H, W = data1.shape
    k = int(kernel_size)
    if k % 2 != 1:
        raise ValueError("kernel_size must be odd")
    kr = k // 2
    bd = max_displacement // stride2
    p = pad_size
    d1 = F.pad(data1, (p, p, p, p))
    d2 = F.pad(data2, (p, p, p, p))
    Hp, Wp = H + 2 * p, W + 2 * p
    border = max_displacement + kr
    Ho = int(math.ceil((Hp - 2 * border) / stride1))
    Wo = int(math.ceil((Wp - 2 * border) / stride1))
    if Ho <= 0 or Wo <= 0:
        raise ValueError("correlation output would be empty; grow pad_size "
                         "or shrink max_displacement/kernel_size")
    norm = float(k * k * C)
    off = border - kr if k > 1 else border
    outs = []
    for dy in range(-bd, bd + 1):
        for dx in range(-bd, bd + 1):
            shifted = torch.roll(d2, shifts=(-dy * stride2, -dx * stride2),
                                 dims=(2, 3))
            prod = d1 * shifted if is_multiply else (d1 - shifted).abs()
            csum = prod.sum(dim=1, keepdim=True)
            if k > 1:
                csum = F.avg_pool2d(csum, k, 1, divisor_override=1)
            sl = csum[:, :, off:off + Ho * stride1:stride1,
                      off:off + Wo * stride1:stride1]
            outs.append(sl / norm)
    return torch.cat(outs, dim=1)


def im2col(data, kernel, stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """(B, C, H, W) -> (B, C*kh*kw, L) patch matrix, channel-major rows
    (``F.unfold``)."""
    return F.unfold(data, _pair(kernel), dilation=_pair(dilate),
                    padding=_pair(pad), stride=_pair(stride))


def col2im(col, output_size, kernel, stride=(1, 1), dilate=(1, 1),
           pad=(0, 0)):
    """Sum patches back into (B, C, H, W): the adjoint of `im2col`, taps
    that overlap add (``F.fold``)."""
    return F.fold(col, _pair(output_size), _pair(kernel),
                  dilation=_pair(dilate), padding=_pair(pad),
                  stride=_pair(stride))


def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=None, num_group: int = 1,
                           num_deformable_group: int = 1):
    """Deformable convolution v1: `offset` (B, 2*ndg*kh*kw, Ho, Wo) holds
    per-tap (dy, dx) pairs; each kernel tap samples the input bilinearly
    at its shifted position, then the taps contract with the weights, one
    product a tap, in f32, returned in `data`'s dtype."""
    if num_group != 1:
        raise ValueError("num_group > 1 is not supported (the deformable "
                         "models the reference ships use num_group=1)")
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    dh, dw = _pair(dilate)
    ph, pw = _pair(pad)
    B, C, H, W = data.shape
    O = int(num_filter if num_filter is not None else weight.shape[0])
    ndg = int(num_deformable_group)
    if C % ndg:
        raise ValueError(f"channels {C} not divisible by "
                         f"num_deformable_group {ndg}")
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dev = data.device
    base_y = (torch.arange(Ho, device=dev) * sh - ph).float()
    base_x = (torch.arange(Wo, device=dev) * sw - pw).float()
    yy, xx = torch.meshgrid(base_y, base_x, indexing="ij")
    cg = C // ndg
    out = torch.zeros((B, O, Ho, Wo), dtype=torch.float32, device=dev)
    off = offset.float().reshape(B, ndg, kh * kw, 2, Ho, Wo)
    w = weight.float()
    d32 = data.float()
    for t in range(kh * kw):
        r, s = divmod(t, kw)
        taps = []
        for g in range(ndg):
            y = yy[None] + r * dh + off[:, g, t, 0]
            x = xx[None] + s * dw + off[:, g, t, 1]
            taps.append(bilinear_gather(d32[:, g * cg:(g + 1) * cg], x, y))
        sampled = torch.cat(taps, dim=1)
        out = out + torch.einsum("bchw,oc->bohw", sampled, w[:, :, r, s])
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out.to(data.dtype)
