"""Array files of the port: `.npz` containers that the JAX package's
``util.save_arrays`` / ``load_arrays`` read and write too (a copy of its
``npz_encode_entry`` / ``npz_decode_entry``: npz has no bfloat16, so a bf16
array is stored as its uint16 bits under a ``__bf16__`` name tag)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["to_numpy", "to_tensor", "save_arrays", "load_arrays"]

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
