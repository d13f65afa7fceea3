"""Explicit device resolution: no silent fallback between CUDA and CPU."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cpu") -> torch.device:
    """Return ``device`` as a ``torch.device``.

    ``None`` means the CPU. Asking for CUDA where no CUDA device exists
    raises instead of running somewhere else.
    """
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False"
        )
    return dev
