"""Frozen copy of the port's exact feature reductions and their float64
combine (``ops/features.py`` of waveformanalysis_tpu_torch at the commit
that added this benchmark). Imports nothing of the program."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
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


def combine_features(
    red: Dict[str, np.ndarray],
    baselines: np.ndarray,
    polarity_codes: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Host-side float64 combine of integer reductions into final features.

    polarity_codes: int8, +1 positive / -1 negative / 0 unknown (unknown is
    treated as negative, matching the reference fallback).
    """
    baselines = np.asarray(baselines, dtype=np.float64)
    min_h = np.asarray(red["min_h"], dtype=np.float64)
    max_h = np.asarray(red["max_h"], dtype=np.float64)
    count_h = np.asarray(red["count_h"])
    sum_a = np.asarray(red["sum_a"], dtype=np.float64)
    count_a = np.asarray(red["count_a"], dtype=np.float64)
    positive = np.asarray(polarity_codes) > 0

    has_h = count_h > 0
    height = np.where(positive, max_h - baselines, baselines - min_h)
    height = np.where(has_h, height, 0.0)
    amp = np.where(has_h, max_h - min_h, 0.0)

    has_a = count_a > 0
    area = np.where(
        positive,
        sum_a - count_a * baselines,
        count_a * baselines - sum_a,
    )
    area = np.where(has_a, area, 0.0)

    return {
        "height": height.astype(np.float32),
        "amp": amp.astype(np.float32),
        "area": area.astype(np.float32),
        "max_abs_diff": np.asarray(red["max_abs_diff"], dtype=np.float32),
    }


def _norm_window(start: int, end: Optional[int], L: int) -> Tuple[int, Optional[int]]:
    """Normalize a python-slice-style window against padded length L."""
    s, e, _ = slice(start, end).indices(L)
    return int(s), int(e)
