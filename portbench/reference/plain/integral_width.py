"""Plain integral-quantile widths, written from the definition of the
upstream ``waveform_width_integral`` (cpu/waveform_width_integral.py): the
positive-going signal clamped at zero, its cumulative integral, and the
sample positions where that integral first reaches ``q_low`` and ``q_high``
of the total (``searchsorted``, side ``left``). Imports nothing of the
program.

The cumulative integral is float32, summed in the order the JAX package's
``jnp.cumsum`` sums on the CPU (XLA's blocked scan): blocks of 16 samples
left to right, the blocks' totals scanned the same way, each block adding
the total of the blocks before it. Another order rounds differently, and a
prefix sum within a rounding step of a target moves its crossing by a
sample.
"""

from __future__ import annotations

from typing import Dict

import torch

BLOCK = 16


def _running(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right running sums along the last axis."""
    out = x.clone()
    for j in range(1, x.shape[-1]):
        out[..., j] = out[..., j - 1] + x[..., j]
    return out


def blocked_prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """Float32 prefix sums of each row of ``x`` (n, L) in the blocked order."""
    n, L = x.shape
    if L <= BLOCK:
        return _running(x)
    nb = -(-L // BLOCK)
    padded = torch.zeros((n, nb * BLOCK), dtype=x.dtype, device=x.device)
    padded[:, :L] = x
    inner = _running(padded.view(n, nb, BLOCK))
    totals = blocked_prefix_sums(inner[:, :, -1].contiguous())
    before = torch.cat([torch.zeros_like(totals[:, :1]), totals[:, :-1]], dim=1)
    return (inner + before[:, :, None]).reshape(n, nb * BLOCK)[:, :L]


def integral_quantile_width(signal: torch.Tensor, q_low: float,
                            q_high: float) -> Dict[str, torch.Tensor]:
    """(n,) t_low, t_high and width in samples, and the total charge, of each
    row of the float32 signal ``signal`` (n, L), every row at its true length.
    A row with no positive charge gets zeros."""
    x = signal.to(torch.float32).clamp(min=0.0)
    csum = blocked_prefix_sums(x)
    total = csum[:, -1]
    ok = (total > 0) & torch.isfinite(total)
    t_low = (csum < (q_low * total)[:, None]).sum(dim=1)
    t_high = (csum < (q_high * total)[:, None]).sum(dim=1)
    t_low = torch.where(ok, t_low, 0).to(torch.float32)
    t_high = torch.where(ok, t_high, 0).to(torch.float32)
    width = torch.where(ok, (t_high - t_low).clamp(min=0.0), 0.0)
    return {"t_low_samples": t_low, "t_high_samples": t_high, "width_samples": width,
            "q_total": total}
