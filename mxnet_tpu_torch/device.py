"""Devices of the port (counterpart of ``mxnet_tpu/device.py`` and
``context.py``).

`resolve_device` is every entry point's one way to a ``torch.device``: the
CUDA card unless the caller asks for the CPU with ``device="cpu"``.  With
no card and no explicit CPU request it raises — the port never drops to
the CPU quietly, so a run that was meant for the card can never report
CPU numbers under a device name.

`Device` (``Context``) is MXNet's name for a placement: ``cpu(i)`` and
``gpu(i)`` wrap ``torch.device("cpu")`` and ``torch.device("cuda", i)``;
``with mx.cpu():`` makes it the current device, which a Gluon
``initialize()`` with no device uses (the card by default).  ``tpu()``
raises: this port runs on NVIDIA cards.

The scope is per thread (JAX's default device is per process): a thread
the framework starts for a caller (a `DataLoader` worker, the device
prefetcher) enters the device that was current where it was built.  A
process that must never touch the card (a spawned `DataLoader` worker)
calls `pin_process_cpu` first: its default is then the CPU, and arrays
unpickled there are rebuilt on the CPU whatever device they left.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from .base import MXNetError

__all__ = ["resolve_device", "Device", "Context", "cpu", "gpu", "tpu",
           "current_device", "current_context", "num_gpus",
           "pin_process_cpu", "process_pinned_cpu"]

# set once, in a process that must stay off the card (`pin_process_cpu`)
_PROCESS_CPU = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (the card); ``"cpu"`` -> the CPU; ``"cuda"`` /
    ``"cuda:<i>"`` -> that card; a `Device` -> its ``torch.device``.
    Raises `MXNetError` when a card is wanted and none is visible."""
    if isinstance(device, Device):
        device = device.torch_device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise MXNetError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is visible; the port runs on the card by "
            "default — pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Device:
    """A placement: ``Device("cpu")``, ``Device("gpu", i)``; a
    ``torch.device`` or its string is taken too."""

    _local = threading.local()

    def __init__(self, device_type: Union[str, "Device", torch.device],
                 device_id: int = 0):
        if isinstance(device_type, Device):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        elif isinstance(device_type, torch.device) or (
                isinstance(device_type, str) and ":" in device_type):
            d = torch.device(device_type)
            device_type, device_id = d.type, d.index or 0
        device_type = device_type.lower()
        if device_type == "cuda":
            device_type = "gpu"
        if device_type == "tpu":
            raise MXNetError("tpu() names the JAX package's chip; this port "
                             "runs on NVIDIA cards — use gpu(i) or cpu()")
        if device_type not in ("cpu", "gpu"):
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    def __eq__(self, other):
        if isinstance(other, (str, torch.device)):
            try:
                other = Device(other)
            except MXNetError:
                return NotImplemented
        if not isinstance(other, Device):
            return NotImplemented
        return self.torch_device == other.torch_device

    def __hash__(self):
        return hash(self.torch_device)

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        stack = getattr(Device._local, "stack", None)
        if stack is None:
            stack = Device._local.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Device._local.stack.pop()
        return False


Context = Device


def cpu(device_id: int = 0) -> Device:
    return Device("cpu", device_id)


def gpu(device_id: int = 0) -> Device:
    return Device("gpu", device_id)


def tpu(device_id: int = 0) -> Device:
    return Device("tpu", device_id)


def current_device() -> Device:
    """The innermost ``with Device(...)`` scope's device, else ``gpu(0)``
    (the card; `resolve_device` raises on it when there is none) — or
    ``cpu(0)`` in a process pinned by `pin_process_cpu`."""
    stack = getattr(Device._local, "stack", None)
    if stack:
        return stack[-1]
    return Device("cpu" if _PROCESS_CPU else "gpu", 0)


def pin_process_cpu() -> None:
    """Make the CPU this process's default device for good, before
    anything is unpickled: a spawned `DataLoader` worker calls it so that
    no array, transform or batch in it ever opens a CUDA context (the
    counterpart of JAX's worker pinning ``jax_platforms`` to ``cpu``)."""
    global _PROCESS_CPU
    _PROCESS_CPU = True


def process_pinned_cpu() -> bool:
    return _PROCESS_CPU


current_context = current_device


def num_gpus() -> int:
    return torch.cuda.device_count()


def as_torch_device(device: Optional[object] = None) -> torch.device:
    """`device` (a `Device`, string, ``torch.device`` or None for the
    current device) resolved to a ``torch.device``."""
    return resolve_device(current_device() if device is None else device)
