"""The fused records -> features -> hits -> S1/S2 chain in plain PyTorch.

Port of ``waveformanalysis_tpu/models/full_chain.py``. ``full_chain_step``
composes the ported ops over a padded ``(n, L)`` batch and is the plain
version that the CUDA chain kernel (``ops/chain_scan_cuda.py``) is held to.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import resolve_device
from waveformanalysis_tpu_torch.ops.features import feature_reductions
from waveformanalysis_tpu_torch.ops.hits import threshold_hits_batch
from waveformanalysis_tpu_torch.ops.peaks import find_peaks_batch, peak_heights_batch
from waveformanalysis_tpu_torch.ops.widths import width_from_peaks

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class ChainConfig:
    """Static configuration of the chain (same fields and defaults as the
    JAX package's ChainConfig)."""

    height_range: Tuple[int, int] = (40, 90)
    area_start: int = 0
    # peak finding (hit plugin defaults)
    peak_height: float = 30.0
    peak_distance: int = 2
    peak_prominence: float = 0.7
    peak_width: float = 4.0
    use_derivative: bool = True
    max_peaks: int = 8
    # threshold hits
    hit_threshold: float = 10.0
    left_extension: int = 2
    right_extension: int = 2
    max_hits: int = 8
    # widths
    rise_low: float = 0.1
    rise_high: float = 0.9
    # classification (samples)
    s1_width_max: float = 30.0
    s2_width_min: float = 40.0

    @classmethod
    def from_fields(cls, fields: Mapping[str, Any]) -> "ChainConfig":
        """Build from a field mapping such as ``dataclasses.asdict`` of the
        JAX package's ChainConfig; unknown keys raise."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(fields) - names
        if unknown:
            raise TypeError(f"unknown ChainConfig fields: {sorted(unknown)}")
        kw = dict(fields)
        if "height_range" in kw:
            kw["height_range"] = tuple(int(v) for v in kw["height_range"])
        return cls(**kw)


def batch_from_numpy(
    waves: np.ndarray,
    event_length: np.ndarray,
    baselines: np.ndarray,
    polarity_codes: np.ndarray,
    device: Union[str, torch.device, None] = "cpu",
) -> Batch:
    """Move a numpy batch to ``device`` with the chain's dtypes:
    int16 waves, int32 lengths, float32 baselines, int8 polarity codes."""
    dev = resolve_device(device)
    return (
        torch.as_tensor(np.asarray(waves, np.int16), device=dev),
        torch.as_tensor(np.asarray(event_length, np.int32), device=dev),
        torch.as_tensor(np.asarray(baselines, np.float32), device=dev),
        torch.as_tensor(np.asarray(polarity_codes, np.int8), device=dev),
    )


def full_chain_step(
    waves: torch.Tensor,
    event_length: torch.Tensor,
    baselines: torch.Tensor,
    polarity_codes: torch.Tensor,
    cfg: ChainConfig,
) -> Dict[str, torch.Tensor]:
    """One fused pass over a padded waveform batch: per-event features,
    peak/hit counts, widths and S1/S2 labels, plus the overflow counters."""
    n, L = waves.shape
    w32 = waves.to(torch.float32)

    # ---- basic features (exact integer reductions, f32 combine) ----------
    hs, he = cfg.height_range
    red = feature_reductions(
        waves, event_length,
        height_start=hs, height_end=min(he, L),
        area_start=cfg.area_start, area_end=L,
    )
    b = baselines.to(torch.float32)
    positive = polarity_codes > 0
    has_h = red["count_h"] > 0
    min_h = red["min_h"].to(torch.float32)
    max_h = red["max_h"].to(torch.float32)
    height = torch.where(has_h, torch.where(positive, max_h - b, b - min_h), 0.0)
    amp = torch.where(has_h, max_h - min_h, 0.0)
    count_a = red["count_a"].to(torch.float32)
    sum_a = red["sum_a"].to(torch.float32)
    area = torch.where(positive, sum_a - count_a * b, count_a * b - sum_a)
    area = torch.where(red["count_a"] > 0, area, 0.0)

    # ---- polarity-normalized signal --------------------------------------
    sign = torch.where(positive, 1.0, -1.0).to(torch.float32)
    signal = sign[:, None] * (w32 - b[:, None])

    # ---- peak finding (hit plugin semantics) ------------------------------
    if cfg.use_derivative:
        det = sign[:, None] * (w32[:, 1:] - w32[:, :-1])
        det_len = (event_length - 1).clamp(min=0)
    else:
        det = signal
        det_len = event_length
    peaks = find_peaks_batch(
        det, height=cfg.peak_height, prominence=cfg.peak_prominence,
        width=cfg.peak_width, distance=cfg.peak_distance,
        max_peaks=cfg.max_peaks, valid_length=det_len.to(torch.int32),
    )
    peak_heights = peak_heights_batch(
        w32, peaks["left_ips"], peaks["right_ips"], peaks["valid"],
    )

    # ---- threshold hits -----------------------------------------------------
    hits = threshold_hits_batch(
        signal,
        torch.full((n,), cfg.hit_threshold, dtype=torch.float32, device=waves.device),
        event_length.to(torch.int32),
        left_extension=cfg.left_extension,
        right_extension=cfg.right_extension,
        max_hits=cfg.max_hits,
    )

    # ---- widths on the dominant peak per event ------------------------------
    best_k = torch.where(peaks["valid"], peak_heights, float("-inf")).argmax(dim=1)
    best_pos = torch.gather(peaks["position"], 1, best_k[:, None])[:, 0]
    has_peak = peaks["valid"].any(dim=1)
    widths = width_from_peaks(
        signal, torch.where(has_peak, best_pos, 0),
        rise_low=cfg.rise_low, rise_high=cfg.rise_high,
        fall_high=cfg.rise_high, fall_low=cfg.rise_low,
    )
    width_samples = torch.where(has_peak & widths["valid"], widths["total_samples"], 0.0)

    # ---- S1/S2 labels ---------------------------------------------------------
    classified = has_peak & (width_samples > 0)
    label = torch.where(
        classified & (width_samples <= cfg.s1_width_max), 1,
        torch.where(classified & (width_samples >= cfg.s2_width_min), 2, 0),
    ).to(torch.int8)

    return {
        "height": height,
        "amp": amp,
        "area": area,
        "max_abs_diff": red["max_abs_diff"].to(torch.float32),
        "peak_position": torch.where(has_peak, best_pos, -1).to(torch.int32),
        "n_peaks": peaks["valid"].sum(dim=1, dtype=torch.int32),
        "n_hits": hits["valid"].sum(dim=1, dtype=torch.int32),
        "hit_integral": torch.where(hits["valid"], hits["integral"], 0.0).sum(dim=1),
        "rise_samples": torch.where(has_peak, widths["rise_samples"], 0.0),
        "fall_samples": torch.where(has_peak, widths["fall_samples"], 0.0),
        "width_samples": width_samples,
        "label": label,
        # events whose candidate peaks / threshold runs exceeded the static
        # max_peaks / max_hits capacity (beyond-K entries are dropped)
        "n_peak_overflow": (peaks["n_candidates"] > cfg.max_peaks).sum(dtype=torch.int32),
        "n_hit_overflow": (hits["n_runs"] > cfg.max_hits).sum(dtype=torch.int32),
    }


CHAIN_OUT_KEYS = (
    "height", "amp", "area", "max_abs_diff", "peak_position", "n_peaks",
    "n_hits", "hit_integral", "rise_samples", "fall_samples",
    "width_samples", "label",
)
CHAIN_STATS_KEYS = ("n_s1", "n_s2", "total_area")
CHAIN_OVERFLOW_KEYS = ("n_peak_overflow", "n_hit_overflow")


class ChainOverflowError(RuntimeError):
    """Raised in strict mode when events exceed the static peak/hit
    capacity (their beyond-K entries would be silently dropped)."""


def run_chain(
    waves: torch.Tensor,
    event_length: torch.Tensor,
    baselines: torch.Tensor,
    polarity_codes: torch.Tensor,
    cfg: Optional[ChainConfig] = None,
    overflow_policy: str = "warn",
) -> Dict[str, torch.Tensor]:
    """Run the chain with an explicit overflow policy.

    policy:
      - ``warn`` (default): log a warning with the overflow counts;
      - ``raise``: raise :class:`ChainOverflowError` (strict mode);
      - ``ignore``: counters are still in the outputs, nothing else.

    The counters (`n_peak_overflow`, `n_hit_overflow`) count events whose
    candidate peaks / threshold runs exceeded ``cfg.max_peaks`` /
    ``cfg.max_hits``; those events keep their first K entries and drop the
    rest (static shapes).
    """
    if overflow_policy not in ("warn", "raise", "ignore"):
        raise ValueError(f"unknown overflow_policy {overflow_policy!r}")
    cfg = cfg or ChainConfig()
    out = make_chain(cfg)(waves, event_length, baselines, polarity_codes)
    if overflow_policy != "ignore":
        n_po = int(out["n_peak_overflow"])
        n_ho = int(out["n_hit_overflow"])
        if n_po or n_ho:
            msg = (
                f"full chain capacity overflow: {n_po} events exceeded "
                f"max_peaks={cfg.max_peaks}, {n_ho} exceeded "
                f"max_hits={cfg.max_hits}; beyond-capacity entries dropped. "
                f"Raise the limits in ChainConfig or use overflow_policy="
                f"'ignore'."
            )
            if overflow_policy == "raise":
                raise ChainOverflowError(msg)
            logging.getLogger(__name__).warning(msg)
    return out


def make_chain(cfg: Optional[ChainConfig] = None):
    """The plain chain as a step function of the four batch tensors."""
    cfg = cfg or ChainConfig()

    def step(waves, event_length, baselines, polarity_codes):
        return full_chain_step(waves, event_length, baselines, polarity_codes, cfg)

    return step


def example_chain_batch(
    n_events: int = 256,
    wave_length: int = 256,
    seed: int = 0,
    device: Union[str, torch.device, None] = "cpu",
) -> Batch:
    """Synthetic mixed S1/S2 batch (positive pulses) for the chain; the same
    numbers as the JAX package's example_chain_batch for the same seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(wave_length)
    waves = np.full((n_events, wave_length), 1000.0)
    for i in range(n_events):
        c = rng.integers(60, wave_length - 60)
        sigma = 3.0 if i % 2 == 0 else 25.0
        amp = 400.0 if i % 2 == 0 else 250.0
        waves[i] += amp * np.exp(-((t - c) ** 2) / (2 * sigma**2))
    waves += rng.normal(0, 2, waves.shape)
    return batch_from_numpy(
        np.round(waves).astype(np.int16),
        np.full(n_events, wave_length, np.int32),
        np.full(n_events, 1000.0, np.float32),
        np.full(n_events, 1, np.int8),  # positive pulses
        device=device,
    )
