"""Default-device resolution for the port's entry points.

Every entry point (`GPTForCausalLM`, `InferenceEngine`, `load_jax_params`)
runs on the CUDA card unless the caller asks for the CPU with
``device="cpu"``.  With no card and no explicit CPU request they raise —
the port never drops to the CPU quietly, so a run that was meant for the
card can never report CPU numbers under a device name.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .base import MXNetError

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (the card); ``"cpu"`` -> the CPU; ``"cuda"`` /
    ``"cuda:<i>"`` -> that card.  Raises `MXNetError` when a card is
    wanted and none is visible."""
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
