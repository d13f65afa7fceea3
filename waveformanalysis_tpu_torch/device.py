"""Explicit device resolution: no silent fallback between CUDA and CPU."""

from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``.

    The port runs on the card unless the caller asks for the CPU: the
    default and ``None`` both mean CUDA. Asking for CUDA where no CUDA
    device exists raises instead of running somewhere else.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run on the CPU)"
        )
    return dev


def scan_backend(choice: str, device: torch.device) -> str:
    """Resolve a plugin's kernel backend option for ``device``.

    ``auto`` runs the hand-written CUDA kernel on a CUDA device and the
    plain PyTorch formulation (``xla``, the JAX package's name for it) on
    the CPU; ``scan`` on the CPU raises, since the kernel runs only on the
    card.
    """
    if choice == "auto":
        return "scan" if device.type == "cuda" else "xla"
    if choice == "scan" and device.type != "cuda":
        raise ValueError(
            f"backend 'scan' runs a CUDA kernel but the Context device is {device}; "
            "use 'auto' or 'xla' on the CPU"
        )
    return choice


def to_numpy(x: Any) -> np.ndarray:
    """A host NumPy array from a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_host(data: Any) -> Any:
    """``data`` with no tensor left in it, for host code that reads it with
    NumPy (the plots, the strax adapters, ``RecordsView``): a Table with its
    columns on the host (``Table.to_host``), a tensor as a NumPy array,
    anything else as it is."""
    if isinstance(data, torch.Tensor):
        return to_numpy(data)
    to_host_ = getattr(data, "to_host", None)
    return to_host_() if callable(to_host_) else data


def to_device(x: Any, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or a host array (copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def on_device(dev: torch.device):
    """The context work on ``dev`` runs under: its CUDA device (so a kernel
    launches there, on its current stream), else none."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()
