"""INT8 quantization workflow (counterpart of
``mxnet_tpu/contrib/quantization.py``; parity with MXNet's
``python/mxnet/contrib/quantization.py`` and
``src/operator/quantization/``), as plain functions on tensors.

- `quantize` / `dequantize` / `requantize`: symmetric int8 with one scale a
  tensor, ranges carried as ``(min, max)`` tensors, as MXNet's ops do.
- `quantize_kv` / `dequantize_kv`: one scale a stored vector, what the
  serving engine's int8 KV pool (``ServeConfig(kv_dtype="int8")``) writes.
  The arithmetic follows the JAX package step for step (``1 / max(scale,
  1e-30)``, then ``round(x * inv)`` half to even, then the clip), so the
  same f32 input gives the JAX package's planes bit for bit.
- `quantized_fully_connected`: int8 x int8 -> int32 with an f32 epilogue,
  per output channel (`ops.quantized_matmul.int8_act_matmul`) or, given
  ``w_amax``, one scale for the whole weight.
- Calibration (`calib_minmax`, `calib_entropy`, `LayerCalibrator`): numpy
  code, copied; its thresholds feed ``InferenceEngine(act_thresholds=)``
  for ``MXTPU_QUANT_ACT=1``.

- `quantize_net` / `QuantizedDense`: MXNet's post-training flow over a
  Gluon net (`gluon.nn`): each ``Dense`` of its ``Sequential`` containers
  calibrated, its weight quantized once a channel, its forward through
  `ops.quantized_matmul.quantized_matmul` (K2 on the card).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import accepts_ndarray, as_tensor

__all__ = [
    "quantize", "dequantize", "requantize", "quantized_fully_connected",
    "calib_minmax", "calib_entropy", "LayerCalibrator", "quantize_net",
    "QuantizedDense", "quantize_kv", "dequantize_kv",
]

INT8_MAX = 127.0


def _f32(v, device) -> torch.Tensor:
    """A float32 tensor of `v` (a number or a tensor) on `device`."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# core ops (parity: src/operator/quantization/{quantize,dequantize,requantize})
# ---------------------------------------------------------------------------

def quantize(data, min_range=None, max_range=None, out_type="int8"):
    """f32 -> int8 with symmetric scaling; returns ``(q, min, max)``, the
    range from the data's abs-max unless both ends are given."""
    if out_type != "int8":
        raise MXNetError("quantization supports int8 only")
    x = torch.as_tensor(data)
    if min_range is None or max_range is None:
        amax = x.abs().amax().float()
    else:
        amax = _f32(max(abs(float(min_range)), abs(float(max_range))),
                    x.device)
    scale = INT8_MAX / torch.clamp(amax, min=1e-12)
    q = torch.clamp(torch.round(x * scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), -amax, amax.clone()


def dequantize(data, min_range, max_range, out_type="float32"):
    """int8 -> f32 given the recorded range."""
    q = torch.as_tensor(data)
    amax = torch.maximum(_f32(min_range, q.device).abs(),
                         _f32(max_range, q.device).abs())
    return q.float() * (amax / INT8_MAX)


def requantize(data, min_range, max_range, out_min, out_max):
    """int32 accumulator -> int8 under a new output range."""
    acc = torch.as_tensor(data)
    dev = acc.device
    in_amax = torch.maximum(_f32(min_range, dev).abs(),
                            _f32(max_range, dev).abs())
    out_amax = torch.maximum(_f32(out_min, dev).abs(),
                             _f32(out_max, dev).abs())
    in_scale = in_amax / (INT8_MAX * INT8_MAX)
    out_scale = INT8_MAX / torch.clamp(out_amax, min=1e-12)
    q = torch.clamp(torch.round(acc.float() * in_scale * out_scale),
                    -INT8_MAX, INT8_MAX)
    return q.to(torch.int8)


def quantize_kv(x, axis=-1):
    """Symmetric per-vector int8 quantization for the serving KV cache:
    each vector along `axis` gets one scale ``amax / 127``.  Returns ``(q
    int8, scale f32)`` with `scale` shaped like `x` without `axis`.  A zero
    vector quantizes to zeros with scale 0 (it dequantizes to 0; no
    division by zero)."""
    xf = x.float()
    scale = xf.abs().amax(dim=axis) / INT8_MAX
    inv = torch.where(scale > 0.0, 1.0 / torch.clamp(scale, min=1e-30),
                      0.0)
    q = torch.clamp(torch.round(xf * inv.unsqueeze(axis)),
                    -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, axis=-1, dtype=torch.float32):
    """Inverse of :func:`quantize_kv`."""
    return (q.float() * scale.unsqueeze(axis)).to(dtype)


def _q8(x, amax):
    scale = INT8_MAX / torch.clamp(_f32(amax, x.device), min=1e-12)
    return torch.clamp(torch.round(x * scale), -INT8_MAX,
                       INT8_MAX).to(torch.int8)


def quantized_fully_connected(x, weight, bias, x_amax, w_amax=None):
    """int8 x int8 -> int32 dense with an f32 dequant epilogue; `x` f32 in,
    f32 out, the quantization internal, as in MXNet's quantized FC with
    calibration.

    ``w_amax=None`` quantizes the weight with one symmetric scale an output
    row (`ops.quantized_matmul.quantize_weight`) and runs
    `int8_act_matmul` at the threshold ``x_amax``; an explicit ``w_amax``
    keeps the one-scale-a-tensor behaviour."""
    from ..ops.quantized_matmul import int8_act_matmul, quantize_weight

    x = torch.as_tensor(x)
    w = torch.as_tensor(weight)
    if w_amax is None:
        out = int8_act_matmul(x, quantize_weight(w, 8), act_amax=x_amax)
    else:
        from ..ops.quantized_matmul import int8_mm_nt
        xq = _q8(x, x_amax)
        wq = _q8(w, w_amax)
        acc = int8_mm_nt(xq.reshape(-1, xq.shape[-1]), wq).reshape(
            *x.shape[:-1], w.shape[0])
        scale = (float(x_amax) / INT8_MAX) * (float(w_amax) / INT8_MAX)
        out = acc.float() * scale
    if bias is not None:
        out = out + torch.as_tensor(bias)
    return out


# ---------------------------------------------------------------------------
# calibration (parity: quantization.py `_LayerOutputMinMaxCollector` /
# `calibrate_entropy`)
# ---------------------------------------------------------------------------

def calib_minmax(samples) -> float:
    """Naive calibration: absolute max over observed activations."""
    return float(np.max(np.abs(samples)))


def calib_entropy(samples, num_bins: int = 2048,
                  num_quantized_bins: int = 255) -> float:
    """KL-divergence threshold search (entropy calibration): the clipping
    amax minimising KL(P||Q) between the f32 histogram and its
    int8-quantized reconstruction."""
    arr = np.abs(np.asarray(samples).ravel())
    amax = arr.max()
    if amax == 0:
        return 1e-8
    # keep bins populated: sparse histograms make the KL search over-clip
    num_bins = int(min(num_bins, max(num_quantized_bins + 1, arr.size // 8)))
    hist, edges = np.histogram(arr, bins=num_bins, range=(0, amax))
    hist = hist.astype(np.float64)
    best_div, best_t = np.inf, amax
    start = num_quantized_bins // 2 + 1
    for i in range(start, num_bins + 1, max(1, num_bins // 128)):
        p = hist[:i].copy()
        outliers = hist[i:].sum()
        p[-1] += outliers
        if p.sum() == 0:
            continue
        # quantize the i-bin histogram down to num_quantized_bins
        idx = np.linspace(0, i, num_quantized_bins + 1).astype(int)
        q = np.zeros(i)
        for b in range(num_quantized_bins):
            lo, hi = idx[b], max(idx[b + 1], idx[b] + 1)
            chunk = hist[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi] = np.where(chunk > 0, chunk.sum() / nz, 0)
        if q.sum() == 0:
            continue
        pn = _smooth_distribution(p)
        qn = _smooth_distribution(q)
        div = np.sum(pn * np.log(pn / qn))
        if div < best_div:
            best_div = div
            best_t = edges[i]
    return float(best_t)


def _smooth_distribution(d, eps=1e-6):
    """Additive smoothing so KL(P||Q) stays finite on sparse histograms."""
    d = d + eps
    return d / d.sum()


class LayerCalibrator:
    """Collects per-layer activation ranges.  Memory-bounded: ``naive``
    keeps a running abs-max; ``entropy`` keeps a running abs-max plus a
    per-layer subsample capped at `max_samples` elements, drawn with
    `rng` (a `numpy.random.Generator` or a seed) once a layer's samples
    would pass the cap."""

    def __init__(self, mode="naive", num_bins=2048, max_samples=1 << 20,
                 rng=None):
        if mode not in ("naive", "entropy"):
            raise MXNetError(f"unknown calibration mode {mode}")
        self.mode = mode
        self.num_bins = num_bins
        self.max_samples = max_samples
        self.amax: Dict[str, float] = {}
        self.samples: Dict[str, list] = {}
        self._counts: Dict[str, int] = {}
        self._rng = np.random.default_rng(rng)

    def observe(self, name: str, value):
        """Record one activation, a torch tensor or a numpy array."""
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy()
        arr = np.abs(np.asarray(value, dtype=np.float32).ravel())
        self.amax[name] = max(self.amax.get(name, 0.0), float(arr.max()))
        if self.mode == "entropy":
            have = self._counts.get(name, 0)
            room = self.max_samples - have
            if room > 0:
                if arr.size > room:
                    arr = arr[self._rng.integers(0, arr.size, room)]
                self.samples.setdefault(name, []).append(arr)
                self._counts[name] = have + arr.size

    def thresholds(self) -> Dict[str, float]:
        out = {}
        for name, amax in self.amax.items():
            if self.mode == "naive":
                out[name] = amax
            else:
                arr = np.concatenate(self.samples[name])
                # embed the true amax so the histogram range is exact even
                # if the subsample missed it
                arr = np.append(arr, amax)
                out[name] = calib_entropy(arr, self.num_bins)
        return out


class QuantizedDense:
    """Inference-only int8 twin of a Gluon ``nn.Dense``: the weight is
    quantized once, one symmetric scale an output channel
    (`ops.quantized_matmul.quantize_weight`), and every forward goes
    through `ops.quantized_matmul.quantized_matmul` -- K2 on the card, the
    serving engine's kernel.  The calibrated ``x_amax`` rides on the
    quantized weight as its activation threshold, so under
    ``MXTPU_QUANT_ACT=1`` the layer takes `int8_act_matmul` instead, as
    the serving matmuls do."""

    def __init__(self, dense, x_amax: float):
        from ..ops.quantized_matmul import quantize_weight
        self._dense = dense
        w = dense.weight.data().detach()
        self.x_amax = float(x_amax)
        self.qt = quantize_weight(w, 8, act_amax=self.x_amax)
        self.w_amax = float(w.abs().max())

    def __call__(self, x):
        from ..ops.quantized_matmul import quantized_matmul
        if self._dense._flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        out = quantized_matmul(x, self.qt, act_amax=self.x_amax)
        if self._dense.bias is not None:
            out = out + self._dense.bias.data().detach()
        act = self._dense.act
        return act(out) if act is not None else out


def quantize_net(net, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers=None,
                 num_calib_batches=None, logger=None):
    """Post-training int8 quantization of a Gluon net's ``Dense`` layers
    (MXNet's ``contrib.quantization.quantize_net``).

    The ``Dense`` children of ``Sequential`` / ``HybridSequential``
    containers (recursively; names in `exclude_layers`, dotted as
    ``"0"`` or ``"1.0"``, are left out) are found; `calib_data` (batches
    of tensors or ``mx.np`` arrays, or ``(data, label)`` tuples) runs
    through the f32 net while a `LayerCalibrator` in `calib_mode`
    ("naive" or "entropy") observes each site's input; then each
    ``Dense`` gets a `QuantizedDense` at its threshold (1.0 without
    calibration data).  Returns a callable net (tensors in and out, or
    arrays) that runs the original with the substitutes; the original is
    left as it is.  A net whose ``forward`` is not a sequential walk needs the
    substitution by hand, as in the JAX package."""
    from ..gluon import nn as _nn

    if quantized_dtype != "int8":
        raise MXNetError("quantize_net supports int8 only")
    exclude = set(exclude_layers or [])
    sites = []

    def walk(block, prefix):
        if not _is_sequential(block):
            return
        for name, child in block._child_items():
            full = f"{prefix}.{name}" if prefix else str(name)
            if isinstance(child, _nn.Dense) and full not in exclude:
                sites.append((full, child))
            else:
                walk(child, full)

    walk(net, "")
    if not sites:
        return net
    if calib_data is not None:
        calib = LayerCalibrator(mode=calib_mode)
        dense = dict(sites)
        with torch.no_grad():
            for n, batch in enumerate(calib_data):
                data = as_tensor(batch[0] if isinstance(
                    batch, (tuple, list)) else batch)
                _forward_with_map(net, data, observer=calib.observe,
                                  sites=dense)
                if num_calib_batches and n + 1 >= num_calib_batches:
                    break
        thresholds = calib.thresholds()
    else:
        thresholds = {}
    return _QuantizedNet(net, {full: QuantizedDense(
        d, thresholds.get(full, 1.0)) for full, d in sites})


def _is_sequential(block):
    from ..gluon import nn as _nn
    return isinstance(block, (_nn.Sequential, _nn.HybridSequential))


def _forward_with_map(block, x, observer=None, sites=None, qmap=None,
                      prefix=""):
    """Run a sequential block tree, observing the inputs of the `sites`
    and/or running the `qmap` substitutes in their places; any block
    that is not a ``Sequential`` container runs whole."""
    if not _is_sequential(block):
        return block(x)
    out = x
    for name, child in block._child_items():
        full = f"{prefix}.{name}" if prefix else str(name)
        if sites is not None and full in sites:
            if observer is not None:
                observer(full, out)
            out = sites[full](out)
        elif qmap is not None and full in qmap:
            out = qmap[full](out)
        elif _is_sequential(child):
            out = _forward_with_map(child, out, observer, sites, qmap, full)
        else:
            out = child(out)
    return out


class _QuantizedNet:
    """The original net run with its ``Dense`` layers swapped for their
    int8 twins."""

    def __init__(self, net, qmap):
        self._net = net
        self._qmap = qmap

    @accepts_ndarray
    def __call__(self, x):
        with torch.no_grad():
            return _forward_with_map(self._net, x, qmap=self._qmap)

    def collect_params(self):
        return self._net.collect_params()
