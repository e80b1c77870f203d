"""`gluon.model_zoo` of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/``): the vision models, built with random
weights, and the local weight store."""
from . import vision  # noqa: F401
from . import model_store  # noqa: F401
from .vision import get_model  # noqa: F401

__all__ = ["vision", "model_store", "get_model"]
