"""`mx.dlpack` (counterpart of ``mxnet_tpu/dlpack.py``): arrays through
DLPack, over ``torch.utils.dlpack``.  A torch tensor shares its memory, so
unlike the JAX package's (immutable) buffers a consumer's writes through
`to_dlpack_for_write` reach the array, as in MXNet."""
from __future__ import annotations

import torch
import torch.utils.dlpack as _tdl

from .ndarray.ndarray import ndarray, wrap

__all__ = ["to_dlpack_for_read", "to_dlpack_for_write", "from_dlpack"]


def to_dlpack_for_read(arr: ndarray):
    """A DLPack capsule over `arr`'s memory, after its queued work."""
    arr.wait_to_read()
    return _tdl.to_dlpack(arr._data.detach())


def to_dlpack_for_write(arr: ndarray):
    """A DLPack capsule over `arr`'s memory: writes through it change
    `arr`."""
    arr.wait_to_write()
    return _tdl.to_dlpack(arr._data.detach())


def from_dlpack(obj) -> ndarray:
    """An array over the memory of a DLPack producer (an object with
    ``__dlpack__`` or a capsule), with no copy."""
    if isinstance(obj, ndarray):
        obj = obj._data
    return wrap(obj if isinstance(obj, torch.Tensor)
                else _tdl.from_dlpack(obj))
