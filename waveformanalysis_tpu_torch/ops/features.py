"""Basic waveform features (height / amp / area / max_abs_diff).

Port of ``waveformanalysis_tpu/ops/features.py`` (``feature_reductions``,
``combine_features``, ``basic_features_device``, ``compute_baselines``):
the device performs only exact integer min/max/count/sum reductions over
the padded ``(n, L)`` int16 matrix; the baseline arithmetic is combined on
the host in float64 (``combine_features``) or, inside a device program, in
float32 (``basic_features_device``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import resolve_device

_BIG = 2**30
_BIG_F = 3.0e38

# bump when reduction semantics change: folded into plugin lineage
KERNEL_VERSION = "features-v2"  # v2: float sources reduce in f32 (no int floor)


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


def basic_features_device(
    waves: torch.Tensor,
    event_length: torch.Tensor,
    baselines: torch.Tensor,
    polarity_codes: torch.Tensor,
    height_start: int = 0,
    height_end: Optional[int] = None,
    area_start: int = 0,
    area_end: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Fully-on-device variant (float32 combine) for composed programs.

    float32 area may differ from the exact float64 combine by ~1e-2 ADC
    units on long integrations (the JAX package's documented tolerance).
    """
    red = feature_reductions(
        waves, event_length,
        height_start=height_start, height_end=height_end,
        area_start=area_start, area_end=area_end,
    )
    f32 = torch.float32
    b = baselines.to(f32)
    positive = polarity_codes > 0
    has_h = red["count_h"] > 0
    min_h = red["min_h"].to(f32)
    max_h = red["max_h"].to(f32)
    height = torch.where(positive, max_h - b, b - min_h)
    height = torch.where(has_h, height, 0.0)
    amp = torch.where(has_h, max_h - min_h, 0.0)
    count_a = red["count_a"].to(f32)
    sum_a = red["sum_a"].to(f32)
    has_a = red["count_a"] > 0
    area = torch.where(positive, sum_a - count_a * b, count_a * b - sum_a)
    area = torch.where(has_a, area, 0.0)
    return {
        "height": height,
        "amp": amp,
        "area": area,
        "max_abs_diff": red["max_abs_diff"].to(f32),
    }


def _norm_window(start: int, end: Optional[int], L: int) -> Tuple[int, Optional[int]]:
    """Normalize a python-slice-style window against padded length L."""
    s, e, _ = slice(start, end).indices(L)
    return int(s), int(e)


def compute_baselines(
    waves: Any,
    window: Tuple[int, int] = (0, 20),
    event_length: Optional[Any] = None,
    device: Union[str, torch.device, None] = "cuda",
) -> np.ndarray:
    """Baseline = mean of the baseline window, float64-exact.

    Integer sums are computed on ``device``; the division happens on the
    host in float64 for exact parity with the reference.
    """
    dev = resolve_device(device)
    waves_d = torch.from_numpy(np.ascontiguousarray(waves)).to(dev)
    n, L = waves_d.shape
    if event_length is None:
        el = torch.full((n,), L, dtype=torch.int32, device=dev)
    else:
        el = torch.from_numpy(np.asarray(event_length, dtype=np.int32)).to(dev)
    s, e = _norm_window(int(window[0]), int(window[1]), L)
    red = feature_reductions(waves_d, el, area_start=s, area_end=e)
    sums = red["sum_a"].cpu().numpy().astype(np.float64)
    counts = red["count_a"].cpu().numpy().astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = sums / counts
    return np.where(counts > 0, out, 0.0)
