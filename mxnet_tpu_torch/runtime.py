"""Runtime feature detection (counterpart of ``mxnet_tpu/runtime.py``,
MXNet's ``mx.runtime``): what this process can use — CUDA and a card,
``nvcc`` to build the port's kernels, which kernel libraries are built,
cuDNN, NCCL, Triton.  JAX's compile-cache warm start is XLA's and raises
by name (ROADMAP.md A14)."""
from __future__ import annotations

import importlib.util
import os
from collections import namedtuple

import torch

from .base import unported

__all__ = ["Features", "feature_list", "libinfo_features",
           "enable_compile_cache", "compile_cache_dir"]

Feature = namedtuple("Feature", ["name", "enabled"])


def _nvcc() -> bool:
    from . import kernels
    try:
        kernels._nvcc()
        return True
    except Exception:
        return False


def _kernels_built() -> bool:
    """Every kernel library of ``csrc/`` is built for these sources."""
    from . import kernels
    d = kernels._build_dir()
    return all(os.path.isfile(os.path.join(d, f"lib{n}.so"))
               for n in kernels._libraries())


def _resolve():
    cuda = torch.cuda.is_available()
    dist = torch.distributed.is_available()
    return {
        "CPU": True,
        "CUDA": cuda,
        "GPU": cuda and torch.cuda.device_count() > 0,
        "TPU": False,
        "XLA": False,
        "PALLAS": False,
        "NVCC": _nvcc(),
        "CUDA_KERNELS_BUILT": _kernels_built(),
        "CUDNN": bool(torch.backends.cudnn.is_available()),
        "NCCL": bool(dist and torch.distributed.is_nccl_available()),
        "TRITON": importlib.util.find_spec("triton") is not None,
        "BF16": True,
        "INT64_TENSOR_SIZE": True,
        "DIST_KVSTORE": False,
        "SIGNAL_HANDLER": True,
        "PROFILER": True,
        "TELEMETRY": True,
        "HEALTH_MONITOR": True,
        "SERVING": True,
        "EXPORT": False,
    }


class Features(dict):
    def __init__(self):
        super().__init__({k: Feature(k, bool(v))
                          for k, v in _resolve().items()})

    def is_enabled(self, name):
        return self[name.upper()].enabled


def feature_list():
    return list(Features().values())


libinfo_features = feature_list

enable_compile_cache = unported("runtime.enable_compile_cache", "A14")


def compile_cache_dir():
    """None: the port has no persistent compile cache (ROADMAP.md A14)."""
    return None
