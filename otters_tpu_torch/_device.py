"""Which device a store lives on: CUDA unless the caller names another."""

from __future__ import annotations

import torch

from .errors import OttersError


def resolve_device(device, how: str) -> torch.device:
    """``device`` as a ``torch.device``; when it is None, the current CUDA
    device, or an error that tells the caller how to ask for the CPU
    (``how``, e.g. ``"VecStore(dim, device='cpu')"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise OttersError(
            f"no CUDA device is available; name the device explicitly with "
            f"{how} to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
