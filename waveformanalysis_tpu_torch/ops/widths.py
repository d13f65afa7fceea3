"""Waveform width: 10-90% threshold-crossing rise/fall around a peak.

Port of ``waveformanalysis_tpu/ops/widths.py`` (``_width_for_positions``,
``width_from_peaks``). Contract: baseline = mean of the first 50 samples;
corrected = wave - baseline; thresholds are fractions of the corrected peak
value; rising crossing = first sample in [0, peak) with corrected >= thr;
falling = first sample in [peak, L) with corrected <= thr; optional linear
interpolation; rows whose corrected peak value <= 0 are not valid.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_BASELINE_SAMPLES = 50


def _width_for_positions(
    corr: torch.Tensor,
    p: torch.Tensor,
    rise_low: float,
    rise_high: float,
    fall_high: float,
    fall_low: float,
    interpolation: bool,
) -> Dict[str, torch.Tensor]:
    """Crossing widths for one peak position per row of ``corr``."""
    h, L = corr.shape
    pos = torch.arange(L, device=corr.device, dtype=torch.int32)[None, :]
    p = p.to(torch.int32)
    p_safe = p.clamp(0, L - 1)
    peak_value = torch.gather(corr, 1, p_safe.long()[:, None])[:, 0]
    valid = (p >= 0) & (p < L) & (peak_value > 0)

    def interp_at(idx: torch.Tensor, thr: torch.Tensor, may: torch.Tensor) -> torch.Tensor:
        # linear interpolation between samples idx-1 and idx; `may` says
        # where the crossing index is eligible for it
        i_safe = idx.clamp(1, L - 1).long()
        y0 = torch.gather(corr, 1, (i_safe - 1)[:, None])[:, 0]
        y1 = torch.gather(corr, 1, i_safe[:, None])[:, 0]
        denom = y1 - y0
        small = denom.abs() < 1e-10
        frac = torch.where(small, 0.0, (thr - y0) / torch.where(small, 1.0, denom))
        interp = (i_safe - 1).to(torch.float32) + frac
        return torch.where(may & ~small, interp, idx.to(torch.float32))

    def crossing(thr: torch.Tensor, rising: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        if rising:  # first index in [0, p) with corr >= thr
            m = (corr >= thr[:, None]) & (pos < p[:, None])
        else:  # first index in [p, L) with corr <= thr
            m = (corr <= thr[:, None]) & (pos >= p[:, None])
        idx = torch.where(m, pos, L).amin(dim=1)
        found = idx < L
        if not interpolation:
            return idx.to(torch.float32), found
        # a falling crossing at the peak itself (relative index 0) never
        # interpolates
        may = idx > 0 if rising else (idx - p) > 0
        return interp_at(idx, thr, may), found

    r_low, r_low_ok = crossing(peak_value * rise_low, True)
    r_high, r_high_ok = crossing(peak_value * rise_high, True)
    f_high, f_high_ok = crossing(peak_value * fall_high, False)
    f_low, f_low_ok = crossing(peak_value * fall_low, False)

    return {
        "rise_samples": torch.where(r_low_ok & r_high_ok, r_high - r_low, 0.0),
        "fall_samples": torch.where(f_high_ok & f_low_ok, f_low - f_high, 0.0),
        "total_samples": torch.where(r_low_ok & f_low_ok, f_low - r_low, 0.0),
        "peak_height": peak_value,
        "valid": valid,
    }


def width_from_peaks(
    waves: torch.Tensor,
    peak_positions: torch.Tensor,
    rise_low: float = 0.1,
    rise_high: float = 0.9,
    fall_high: float = 0.9,
    fall_low: float = 0.1,
    interpolation: bool = True,
) -> Dict[str, torch.Tensor]:
    """Rise/fall/total widths for one peak per row.

    waves: (h, L), the waveform each row's peak lies in;
    peak_positions: (h,) sample index of the peak within each row.

    Returns (h,) tensors: rise_samples, fall_samples, total_samples,
    peak_height, valid.
    """
    w = waves.to(torch.float32)
    nb = min(_BASELINE_SAMPLES, w.shape[1])
    # sum / nb, as jnp.mean computes it (torch's CUDA mean multiplies by
    # 1/nb, which can round differently)
    baseline = w[:, :nb].sum(dim=1) / nb
    corr = w - baseline[:, None]
    return _width_for_positions(
        corr, peak_positions, rise_low, rise_high, fall_high, fall_low,
        interpolation,
    )
