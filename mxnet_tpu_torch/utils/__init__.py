"""Utilities of the port: `CheckpointManager` (counterpart of
``mxnet_tpu/utils/checkpoint.py``)."""
from .checkpoint import CheckpointManager  # noqa: F401

__all__ = ["CheckpointManager"]
