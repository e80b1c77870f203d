"""Contributed modules of the port (counterpart of
``mxnet_tpu/contrib``): `quantization`, MXNet's int8 workflow."""
from . import quantization  # noqa: F401

__all__ = ["quantization"]
