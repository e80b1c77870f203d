"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
`split_data`, `split_and_load` and `clip_global_norm` on tensors and on
``mx.np`` arrays (given arrays, they return arrays).
`download` raises: the port's models take seeded random weights and the
card's machine has no network."""
from __future__ import annotations

import hashlib
import math
import os
import warnings
from typing import List

import torch

from ..base import MXNetError
from ..device import as_torch_device
from ..ndarray.ndarray import accepts_ndarray, ndarray

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download", "replace_file"]


@accepts_ndarray
def split_data(data, num_slice: int, batch_axis=0, even_split=True):
    """`num_slice` slices along `batch_axis`; uneven sizes split as
    ``numpy.array_split`` does (the first slices one row longer)."""
    data = torch.as_tensor(data)
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(f"cannot evenly split axis of size {size} into "
                         f"{num_slice}")
    return list(torch.tensor_split(data, num_slice, dim=batch_axis))


@accepts_ndarray
def split_and_load(data, ctx_list=None, device_list=None, batch_axis=0,
                   even_split=True):
    """`split_data` over the devices, each slice moved to its device."""
    devices = device_list or ctx_list
    data = torch.as_tensor(data)
    if len(devices) == 1:
        return [data.to(as_torch_device(devices[0]))]
    return [s.to(as_torch_device(d)) for s, d in zip(
        split_data(data, len(devices), batch_axis, even_split), devices)]


def clip_global_norm(arrays: List[torch.Tensor], max_norm: float,
                     check_isfinite=True) -> float:
    """Scale `arrays` in place so that their joint L2 norm is at most
    `max_norm`; returns the norm before scaling (a non-finite norm warns
    and scales nothing).  ``mx.np`` arrays are scaled in place too."""
    arrays = [a._data if isinstance(a, ndarray) else a for a in arrays]
    total = sum(float((a.detach().float() ** 2).sum()) for a in arrays)
    norm = math.sqrt(total)
    if check_isfinite and not math.isfinite(norm):
        warnings.warn("nan or inf in clip_global_norm")
        return norm
    scale = min(1.0, max_norm / (norm + 1e-8))
    if scale < 1.0:
        with torch.no_grad():
            for a in arrays:
                a.mul_(scale)
    return norm


def check_sha1(filename, sha1_hash):
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for data in iter(lambda: f.read(1048576), b""):
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise MXNetError("download is not ported: the port's models take "
                     "weights from a seed, and its runs have no network")


def replace_file(src, dst):
    os.replace(src, dst)
