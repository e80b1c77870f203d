"""Batchify functions of the port (counterpart of
``mxnet_tpu/gluon/data/batchify.py``; parity:
`python/mxnet/gluon/data/batchify.py`).  Samples are stacked on the host
and the batch becomes one `mx.np` array on the current device."""
from __future__ import annotations

import numpy as _onp
import torch

from ...ndarray.ndarray import ndarray, wrap

__all__ = ["Stack", "Pad", "Group"]


def _as_np(x):
    if isinstance(x, torch.Tensor):
        x = wrap(x)
    if isinstance(x, ndarray):
        return x.asnumpy()
    return _onp.asarray(x)


class Stack:
    def __call__(self, data):
        from ... import numpy as mnp
        return mnp.array(_onp.stack([_as_np(d) for d in data]))


class Pad:
    def __init__(self, axis=0, val=0, dtype=None):
        self._axis = axis
        self._val = val
        self._dtype = dtype

    def __call__(self, data):
        from ... import numpy as mnp
        arrs = [_as_np(d) for d in data]
        max_len = max(a.shape[self._axis] for a in arrs)
        padded = []
        for a in arrs:
            pad_width = [(0, 0)] * a.ndim
            pad_width[self._axis] = (0, max_len - a.shape[self._axis])
            padded.append(_onp.pad(a, pad_width, constant_values=self._val))
        out = _onp.stack(padded)
        if self._dtype:
            out = out.astype(self._dtype)
        return mnp.array(out)


class Group:
    """Apply per-field batchify fns to tuple samples (reference: Tuple)."""

    def __init__(self, *fns):
        if len(fns) == 1 and isinstance(fns[0], (list, tuple)):
            fns = fns[0]
        self._fns = fns

    def __call__(self, data):
        return tuple(fn([d[i] for d in data])
                     for i, fn in enumerate(self._fns))


Tuple = Group
