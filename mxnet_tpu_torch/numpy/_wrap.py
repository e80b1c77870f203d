"""``mx.np``'s wrapper over a function on tensors (counterpart of
``mxnet_tpu/numpy/_wrap.py``): `wrap_fn` unwraps every `ndarray` argument
(inside lists and tuples too), runs the body under the recording rule of
`ndarray.apply`, wraps the tensors it returns and honours ``out=``."""
from __future__ import annotations

import functools
from typing import Callable, Optional

from ..ndarray.ndarray import _write_out, apply

__all__ = ["wrap_fn"]


def wrap_fn(tfn: Callable, name: Optional[str] = None) -> Callable:
    fname = name or tfn.__name__

    @functools.wraps(tfn)
    def fn(*args, out=None, **kwargs):
        return _write_out(apply(tfn, *args, **kwargs), out)

    fn.__name__ = fn.__qualname__ = fname
    return fn
