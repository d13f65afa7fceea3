"""Basic waveform feature reductions (height / amp / area / max_abs_diff).

Port of ``waveformanalysis_tpu/ops/features.py::feature_reductions``: only
exact integer min/max/count/sum reductions over the padded ``(n, L)`` int16
matrix run here; the baseline arithmetic is combined by the caller.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

_BIG = 2**30
_BIG_F = 3.0e38


def feature_reductions(
    waves: torch.Tensor,
    event_length: torch.Tensor,
    height_start: int = 0,
    height_end: Optional[int] = None,
    area_start: int = 0,
    area_end: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Exact window reductions over a padded wave matrix.

    Args:
        waves: (n, L) integer ADC samples (padding beyond event_length ignored).
        event_length: (n,) true sample count per event.
        height_start/height_end: sample window for min/max (end=None -> L).
        area_start/area_end: sample window for the sum (end=None -> L).

    Returns dict of (n,) tensors: min_h, max_h (int32, saturated at +/-2^30
    when the window is empty), count_h, sum_a, count_a, max_abs_diff.
    Float sources reduce in float32 instead of int32.
    """
    n, L = waves.shape
    is_float = waves.dtype.is_floating_point
    w = waves.to(torch.float32 if is_float else torch.int32)
    big = _BIG_F if is_float else _BIG
    idx = torch.arange(L, device=waves.device, dtype=torch.int32)[None, :]
    valid = idx < event_length[:, None]

    h_end = L if height_end is None else height_end
    a_end = L if area_end is None else area_end
    hmask = valid & (idx >= height_start) & (idx < h_end)
    amask = valid & (idx >= area_start) & (idx < a_end)

    min_h = torch.where(hmask, w, big).amin(dim=1)
    max_h = torch.where(hmask, w, -big).amax(dim=1)
    count_h = hmask.sum(dim=1, dtype=torch.int32)

    # int32 is exact while L * 32768 < 2^31, i.e. wave_len < 65536; callers
    # keep L below that (the JAX package's contract, kept for equal dtypes)
    sum_a = torch.where(amask, w, 0).sum(
        dim=1, dtype=torch.float32 if is_float else torch.int32
    )
    count_a = amask.sum(dim=1, dtype=torch.int32)

    if L > 1:
        diff = (w[:, 1:] - w[:, :-1]).abs()
        dvalid = idx[:, 1:] < event_length[:, None]  # sample i+1 inside event
        max_abs_diff = torch.where(dvalid, diff, 0).amax(dim=1)
    else:
        max_abs_diff = torch.zeros(n, dtype=w.dtype, device=waves.device)

    return {
        "min_h": min_h,
        "max_h": max_h,
        "count_h": count_h,
        "sum_a": sum_a,
        "count_a": count_a,
        "max_abs_diff": max_abs_diff,
    }
