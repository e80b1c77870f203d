"""Kernel-route policy (counterpart of ``mxnet_tpu/ops/pallas/__init__.py``
``pallas_mode`` / ``kernel_active``).

One environment variable, ``MXTPU_PALLAS``, with the JAX package's
spellings, decides whether the ops whose JAX counterparts consult
``kernel_active()`` — the fused LayerNorm/RMSNorm (`ops.fused_norm`), the
multi-tensor optimizer (`ops.fused_optimizer`), the dequant-matmul
(`ops.quantized_matmul`) and the MoE dispatch and combine
(`ops.moe_dispatch`) — take their kernel route:

- ``auto`` (default): the kernel route exactly when the tensor is on a
  CUDA card, the plain route on the CPU;
- ``kernel``: the kernel route everywhere.  On a CUDA tensor that launches
  the hand-written kernel (or raises); on a CPU tensor it runs the
  kernel's plain version — the port's counterpart of JAX's
  ``MXTPU_PALLAS_INTERPRET``, so CPU tests hold the kernel route against
  the JAX package's interpreter;
- ``reference`` and ``off``: the plain route everywhere, even on the card.

Flash attention and the cross-entropy keep their own dispatch (the card
launches their kernels whatever the mode), as their JAX counterparts do.
"""
from __future__ import annotations

import os

import torch

__all__ = ["pallas_mode", "kernel_active"]


def pallas_mode() -> str:
    """``MXTPU_PALLAS`` resolved to one of auto|kernel|reference|off."""
    v = os.environ.get("MXTPU_PALLAS", "auto").strip().lower()
    if v in ("off", "0", "false", "no"):
        return "off"
    if v in ("reference", "ref"):
        return "reference"
    if v in ("kernel", "force", "pallas"):
        return "kernel"
    return "auto"


def kernel_active(x) -> bool:
    """Should an op on `x` (a tensor or a `torch.device`) take its kernel
    route?  ``kernel``: yes; ``reference`` / ``off``: no; ``auto``: when
    `x` lives on a CUDA card."""
    mode = pallas_mode()
    if mode == "kernel":
        return True
    if mode in ("reference", "off"):
        return False
    dev = x if isinstance(x, torch.device) else x.device
    return dev.type == "cuda"
