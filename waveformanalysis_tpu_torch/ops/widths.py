"""Waveform width: 10-90% threshold-crossing rise/fall, integral quantiles.

Port of ``waveformanalysis_tpu/ops/widths.py`` (``_width_for_positions``,
``width_from_peaks``, ``width_from_peak_slots``,
``width_from_peak_slots_scan``, ``integral_quantile_width``). Contracts:

- rise/fall: baseline = mean of the first 50 samples; corrected = wave -
  baseline; thresholds are fractions of the corrected peak value; rising
  crossing = first sample in [0, peak) with corrected >= thr; falling =
  first sample in [peak, L) with corrected <= thr; optional linear
  interpolation; rows whose corrected peak value <= 0 are not valid.
- integral quantile: x = max(signal, 0); t_q = searchsorted(cumsum(x),
  q * total, side='left'), with the float32 prefix sums associated as the
  JAX package's XLA build on the CPU associates them (:func:`cumsum_xla`).

The baseline is the window's sum divided by its count, as the JAX
package's Pallas chain kernel forms it, and the corrected row is wave
minus that baseline. Neither torch's CUDA ``mean`` nor the JAX package's
XLA chain is that: both multiply by 1/n, and XLA's CPU build may fuse the
product into the subtraction (one fused multiply-add, depending on the
shape), so on a row whose peak equals its baseline exactly the JAX XLA
chain can find a positive peak where this and the Pallas kernel find 0.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

KERNEL_VERSION = "widths-v1"

# XLA's CPU build rewrites a cumulative sum into blocks of this many
# samples (see cumsum_xla)
_SCAN_BLOCK = 16

_BASELINE_SAMPLES = 50


def _width_baseline(w: torch.Tensor) -> torch.Tensor:
    """Mean of the first 50 samples of each float32 row (sum / count)."""
    nb = min(_BASELINE_SAMPLES, w.shape[1])
    return w[:, :nb].sum(dim=1) / nb


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
    corr = w - _width_baseline(w)[:, None]
    return _width_for_positions(
        corr, peak_positions, rise_low, rise_high, fall_high, fall_low,
        interpolation,
    )


def width_from_peak_slots(
    waves: torch.Tensor,
    positions: torch.Tensor,
    slot_valid: torch.Tensor,
    rise_low: float = 0.1,
    rise_high: float = 0.9,
    fall_high: float = 0.9,
    fall_low: float = 0.1,
    interpolation: bool = True,
) -> Dict[str, torch.Tensor]:
    """Widths for fixed-capacity peak slot tables, inside a fused program.

    waves: (n, L); positions / slot_valid: (n, K) from the peak kernel.
    Returns (n, K) tensors matching :func:`width_from_peaks` per slot, plus
    ``valid`` = the input slot mask (so device compaction aligns width rows
    1:1 with the emitted hit table) and ``width_valid`` = the width
    kernel's own validity (positive corrected peak, in-range position) as
    int32, which the host filter applies like the standalone plugin.
    """
    w = waves.to(torch.float32)
    corr = w - _width_baseline(w)[:, None]
    outs = [
        _width_for_positions(
            corr, positions[:, k], rise_low, rise_high, fall_high, fall_low,
            interpolation,
        )
        for k in range(positions.shape[1])
    ]
    stacked = {
        key: torch.stack([o[key] for o in outs], dim=1)
        for key in ("rise_samples", "fall_samples", "total_samples",
                    "peak_height")
    }
    stacked["width_valid"] = torch.stack(
        [o["valid"] for o in outs], dim=1
    ).to(torch.int32)
    stacked["valid"] = slot_valid
    stacked["position"] = positions.to(torch.int32)
    return stacked


def width_from_peak_slots_scan(
    waves: torch.Tensor,
    positions: torch.Tensor,
    slot_valid: torch.Tensor,
    rise_low: float = 0.1,
    rise_high: float = 0.9,
    fall_high: float = 0.9,
    fall_low: float = 0.1,
    interpolation: bool = True,
) -> Dict[str, torch.Tensor]:
    """Scan-kernel backend of :func:`width_from_peak_slots`, same contract.

    The first-crossing search runs in the width scan kernel
    (ops/width_scan_cuda.py, one walk of the wave per event for all K
    slots); the interpolation and validity arithmetic below is
    ``_width_for_positions``'s, applied to the emitted indices and capture
    samples, so every consumed output matches the plain formulation.
    """
    from waveformanalysis_tpu_torch.ops.width_scan_cuda import (
        width_crossings_scan,
    )

    L = waves.shape[1]
    baseline = _width_baseline(waves.to(torch.float32))
    cr = width_crossings_scan(
        waves, baseline, positions.to(torch.int32).contiguous(),
        rise_low=rise_low, rise_high=rise_high,
        fall_high=fall_high, fall_low=fall_low,
        interpolation=interpolation,
    )
    p = positions.to(torch.int32)
    pv = cr["peak_value"]
    valid = (p >= 0) & (p < L) & (pv > 0)

    def fin(idx, y0, y1, thr, rel_base):
        # crossing_rising/crossing_falling's tail from _width_for_positions:
        # rel_base is idx (rising) or idx - p (falling); not-found
        # (idx == L) values are masked by ``found`` in every consumer
        found = idx < L
        if not interpolation:
            return idx.to(torch.float32), found
        denom = y1 - y0
        small = denom.abs() < 1e-10
        frac = torch.where(small, 0.0, (thr - y0) / torch.where(small, 1.0, denom))
        interp = (idx - 1).to(torch.float32) + frac
        return torch.where((rel_base > 0) & ~small, interp,
                           idx.to(torch.float32)), found

    r_low, r_low_ok = fin(cr["r_low_idx"], cr["r_low_y0"], cr["r_low_y1"],
                          pv * rise_low, cr["r_low_idx"])
    r_high, r_high_ok = fin(cr["r_high_idx"], cr["r_high_y0"], cr["r_high_y1"],
                            pv * rise_high, cr["r_high_idx"])
    f_high, f_high_ok = fin(cr["f_high_idx"], cr["f_high_y0"], cr["f_high_y1"],
                            pv * fall_high, cr["f_high_idx"] - p)
    f_low, f_low_ok = fin(cr["f_low_idx"], cr["f_low_y0"], cr["f_low_y1"],
                          pv * fall_low, cr["f_low_idx"] - p)
    return {
        "rise_samples": torch.where(r_low_ok & r_high_ok, r_high - r_low, 0.0),
        "fall_samples": torch.where(f_high_ok & f_low_ok, f_low - f_high, 0.0),
        "total_samples": torch.where(r_low_ok & f_low_ok, f_low - r_low, 0.0),
        "peak_height": pv,
        "width_valid": valid.to(torch.int32),
        "valid": slot_valid,
        "position": p,
    }


def _cumsum_left(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last dim, added left to right."""
    cols = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., k])
    return torch.stack(cols, dim=-1)


def cumsum_xla(x: torch.Tensor) -> torch.Tensor:
    """Float32 prefix sums of each row of ``x`` (n, L), associated as the
    JAX package's ``jnp.cumsum`` runs on the CPU, bit for bit.

    XLA rewrites the cumulative sum into blocks of 16 samples: each block
    is summed left to right, the blocks' totals are scanned the same way
    (recursively), and each block adds the total of the blocks before it.
    ``torch.cumsum`` associates differently on the CPU and on CUDA, and a
    prefix sum within a rounding step of a quantile target then moves
    that target's crossing by a sample. Spelled out in elementwise adds,
    the order is the same on every device.
    """
    n, L = x.shape
    if L <= _SCAN_BLOCK:
        return _cumsum_left(x) if L else x.clone()
    nb = -(-L // _SCAN_BLOCK)
    blocks = F.pad(x, (0, nb * _SCAN_BLOCK - L)).view(n, nb, _SCAN_BLOCK)
    inner = _cumsum_left(blocks)
    totals = cumsum_xla(inner[:, :, -1].contiguous())
    carry = torch.cat([torch.zeros_like(totals[:, :1]), totals[:, :-1]], dim=1)
    return (inner + carry[:, :, None]).reshape(n, nb * _SCAN_BLOCK)[:, :L]


def integral_quantile_width(
    signal: torch.Tensor,
    valid_length: torch.Tensor,
    q_low: float = 0.10,
    q_high: float = 0.90,
) -> Dict[str, torch.Tensor]:
    """Cumulative-integral quantile width per event.

    signal: (n, L) polarity-normalized (positive-going) baseline-corrected
    signal; padding beyond valid_length is masked here.
    """
    x = signal.to(torch.float32).clamp(min=0.0)
    n, L = x.shape
    pos = torch.arange(L, device=x.device, dtype=torch.int32)[None, :]
    x = torch.where(pos < valid_length[:, None], x, 0.0)
    csum = cumsum_xla(x)
    # the total at each row's own last sample: the blocked sums reach the
    # end of a row padded past its length by another association, a
    # rounding away, and the quantile targets would move with the padding
    last = (valid_length.to(torch.int64) - 1).clamp(0, L - 1)
    q_total = torch.gather(csum, 1, last[:, None])[:, 0]
    ok = (q_total > 0) & torch.isfinite(q_total)

    # searchsorted(csum, target, 'left') == count of csum < target
    t_low = (csum < (q_low * q_total)[:, None]).sum(dim=1)
    t_high = (csum < (q_high * q_total)[:, None]).sum(dim=1)
    t_low = torch.where(ok, t_low, 0).to(torch.float32)
    t_high = torch.where(ok, t_high, 0).to(torch.float32)
    width = (t_high - t_low).clamp(min=0.0)
    return {
        "t_low_samples": t_low,
        "t_high_samples": t_high,
        "width_samples": torch.where(ok, width, 0.0),
        "q_total": q_total,
    }
