"""Utilities of the port (counterpart of ``mxnet_tpu/util.py``).

Array files: `.npz` containers that the JAX package's ``util.save_arrays``
/ ``load_arrays`` read and write too (a copy of its ``npz_encode_entry`` /
``npz_decode_entry``: npz has no bfloat16, so a bf16 array is stored as its
uint16 bits under a ``__bf16__`` name tag).

NumPy semantics: ``mx.np`` always has NumPy's array and shape semantics
(one array type; 0-d and zero-size arrays), so `is_np_array` and
`is_np_shape` are True and the switches that turn them on are accepted.
Turning shape semantics off serves only MXNet 1.x's ``mx.nd`` operators,
which the port does not have: it raises naming ROADMAP.md A16.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .base import MXNetError

__all__ = ["to_numpy", "to_tensor", "save_arrays", "load_arrays",
           "is_np_array", "is_np_shape", "set_np_shape", "set_np",
           "reset_np", "np_shape", "np_array", "use_np_shape",
           "use_np_array", "use_np", "use_np_default_dtype", "getenv",
           "setenv", "default_array"]

_BF16 = "__bf16__"


def to_numpy(t) -> np.ndarray:
    """A host copy of `t`; a bf16 tensor comes back as its uint16 bits."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def to_tensor(arr, bf16: bool = False) -> torch.Tensor:
    """`arr` (numpy or a tensor) as a tensor; ``bf16`` reads uint16 bits
    as bfloat16, and numpy's own bfloat16 (ml_dtypes) is taken as bits."""
    if torch.is_tensor(arr):
        return arr
    src = np.asarray(arr)
    if src.dtype.name == "bfloat16":
        src, bf16 = src.view(np.uint16), True
    if bf16:
        return torch.from_numpy(src.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(src).copy())


def save_arrays(fname: str, arrays: Dict[str, object]) -> None:
    """Write name -> tensor (or numpy array) to `fname` as `.npz`."""
    out = {}
    for k, v in arrays.items():
        bf16 = torch.is_tensor(v) and v.dtype == torch.bfloat16
        out[(_BF16 + k) if bf16 else k] = to_numpy(v)
    with open(fname, "wb") as f:
        np.savez(f, **out)


def load_arrays(fname: str) -> Dict[str, torch.Tensor]:
    """Read an `.npz` written by `save_arrays` or by the JAX package: name
    -> CPU tensor, bf16 entries decoded."""
    out = {}
    with np.load(fname, allow_pickle=False) as z:
        for k in z.files:
            if k.startswith(_BF16):
                out[k[len(_BF16):]] = to_tensor(z[k], bf16=True)
            else:
                out[k] = to_tensor(z[k])
    return out


# -- NumPy-semantics scopes ---------------------------------------------------

def _legacy_shape():
    raise MXNetError("MXNet 1.x shape semantics are not ported yet "
                     "(ROADMAP.md A16)")


def is_np_array():
    return True


def is_np_shape():
    return True


def set_np_shape(active):
    """NumPy shape semantics are always on: `active` must be true (False
    raises, ROADMAP.md A16); returns the previous state, True."""
    if not active:
        _legacy_shape()
    return True


def set_np(shape=True, array=True, dtype=False):
    if not shape and array:
        raise ValueError("NumPy-array semantics require NumPy-shape "
                         "semantics")
    set_np_shape(shape)


def reset_np():
    set_np_shape(False)


class np_shape:
    """Scope (or decorator) of NumPy shape semantics, which are always on;
    a scope that turns them off raises (ROADMAP.md A16)."""

    def __init__(self, active=True):
        if not active:
            _legacy_shape()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def __call__(self, fn):
        return fn


class np_array:
    """Array-semantics scope: always on (one array type); accepted."""

    def __init__(self, active=True):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def __call__(self, fn):
        return fn


def use_np_shape(fn):
    return np_shape(True)(fn)


def use_np_array(fn):
    return fn


def use_np(fn):
    return use_np_array(use_np_shape(fn))


def use_np_default_dtype(fn):
    return fn


def getenv(name):
    return os.environ.get(name)


def setenv(name, value):
    os.environ[name] = value


def default_array(source_array, ctx=None, dtype=None):
    from .numpy import array
    return array(source_array, dtype=dtype, ctx=ctx)
