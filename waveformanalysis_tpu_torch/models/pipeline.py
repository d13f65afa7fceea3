"""The flagship fused feature pipeline in plain PyTorch.

Port of ``waveformanalysis_tpu/models/pipeline.py``: one pass over a padded
``(n_events, wave_len)`` int16 batch, baseline -> polarity-normalised
signal -> height and area -> threshold-hit proxies -> a width proxy -> the
S1/S2 label, every output a per-event tensor on the batch's device. It has
no kernel of its own: each step is one or two PyTorch operations over the
whole batch, as the JAX package leaves it to XLA.

The JAX dtypes are kept: the baseline is an int32 sum (torch would widen it
to int64) divided by a float32 count, the counts are int32 and the label
int8. ``make_jit_step`` keeps its name and returns an eager closure (PyTorch
needs no compile step); ``make_sharded_step`` runs the step on every shard
of a :class:`~waveformanalysis_tpu_torch.parallel.mesh.Mesh` and sums the
run statistics over the shards in shard order on the mesh's first device,
where the JAX package uses ``psum``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import resolve_device
from waveformanalysis_tpu_torch.parallel.scan import make_sharded_pipeline

PIPELINE_VERSION = "pipeline-v1"

OUT_KEYS = ("baseline", "height", "area", "n_hits", "width_samples", "label")
_STATS_KEYS = ("n_s1", "n_s2", "total_area")


@dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the step (the JAX package's fields and
    defaults; the frozen dataclass hashes the same field tuple)."""

    baseline_window: Tuple[int, int] = (0, 20)
    height_range: Tuple[int, int] = (40, 90)
    area_start: int = 0
    hit_threshold: float = 30.0
    # S1/S2 separation on simple features (width proxy via area/height)
    s1_max_width_samples: float = 12.0
    s2_min_width_samples: float = 30.0


def forward_step(
    waves: torch.Tensor,
    event_length: torch.Tensor,
    polarity_codes: torch.Tensor,
    cfg: PipelineConfig,
) -> Dict[str, torch.Tensor]:
    """One fused pass: baseline -> features -> hits -> S1/S2 labels, on the
    tensors' device. All outputs are per-event tensors."""
    n, L = waves.shape
    w = waves.to(torch.int32)
    idx = torch.arange(L, dtype=torch.int32, device=waves.device)[None, :]
    valid = idx < event_length[:, None]

    # baseline: mean over the baseline window (an int32 sum over a float32 count)
    bs, be = cfg.baseline_window
    bmask = valid & (idx >= bs) & (idx < be)
    bcount = bmask.sum(dim=1, dtype=torch.int32).clamp(min=1)
    bsum = torch.where(bmask, w, 0).sum(dim=1, dtype=torch.int32)
    baseline = bsum.to(torch.float32) / bcount.to(torch.float32)

    # polarity-normalized signal: positive-going pulse
    sign = torch.where(polarity_codes > 0, 1.0, -1.0).to(torch.float32)
    signal = sign[:, None] * (w.to(torch.float32) - baseline[:, None])
    signal = torch.where(valid, signal, 0.0)

    # features over windows
    hs, he = cfg.height_range
    hmask = valid & (idx >= hs) & (idx < he)
    height = torch.where(hmask, signal, -torch.inf).amax(dim=1)
    height = torch.where(hmask.any(dim=1), height, 0.0)
    amask = valid & (idx >= cfg.area_start)
    area = torch.where(amask, signal, 0.0).sum(dim=1)

    # threshold hit detection: samples above threshold, contiguous-run proxy
    above = signal > cfg.hit_threshold
    has_hit = (above & valid).any(dim=1)
    # rising edges = starts of hit runs
    prev = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=waves.device),
                      above[:, :-1]], dim=1)
    n_hits = (above & ~prev).sum(dim=1, dtype=torch.int32)

    # width proxy: samples above 10% of height
    thresh10 = 0.1 * height[:, None]
    width_samples = ((signal > thresh10) & valid & (height[:, None] > 0)).sum(
        dim=1, dtype=torch.int32)

    # S1/S2 classification (0 unknown, 1 S1, 2 S2)
    w_f = width_samples.to(torch.float32)
    label = torch.where(
        has_hit & (w_f <= cfg.s1_max_width_samples), 1,
        torch.where(has_hit & (w_f >= cfg.s2_min_width_samples), 2, 0),
    ).to(torch.int8)

    return {
        "baseline": baseline,
        "height": height,
        "area": area,
        "n_hits": n_hits,
        "width_samples": width_samples,
        "label": label,
    }


def make_jit_step(cfg: Optional[PipelineConfig] = None):
    """Single-device step closure (eager; the JAX package's name)."""
    cfg = cfg or PipelineConfig()

    def step(waves, event_length, polarity_codes):
        return forward_step(waves, event_length, polarity_codes, cfg)

    return step


def make_sharded_step(mesh, cfg: Optional[PipelineConfig] = None, axis: str = "data"):
    """Full pipeline step sharded over the event axis of ``mesh``.

    Per-event outputs come back as ShardedTensors like their inputs; the
    run-level statistics ``run_stats`` = (S1 count, S2 count, total area),
    float32, are each shard's sums summed over the shards in shard order,
    once, on the mesh's first device. The event count must be a multiple of
    the shard count.
    """
    cfg = cfg or PipelineConfig()

    def local_step(waves, event_length, polarity_codes):
        out = forward_step(waves, event_length, polarity_codes, cfg)
        out["n_s1"] = (out["label"] == 1).sum(dtype=torch.int32)
        out["n_s2"] = (out["label"] == 2).sum(dtype=torch.int32)
        out["total_area"] = out["area"].sum()
        return out

    sharded = make_sharded_pipeline(mesh, local_step, 3, OUT_KEYS + _STATS_KEYS,
                                    stats_keys=_STATS_KEYS, axis_name=axis)

    def step(waves, event_length, polarity_codes):
        out = sharded(waves, event_length, polarity_codes)
        stats = [out.pop(k) for k in _STATS_KEYS]
        out["run_stats"] = torch.stack(
            [stats[0].to(torch.float32), stats[1].to(torch.float32), stats[2]])
        return out

    return step


def example_batch(
    n_events: int = 256,
    wave_length: int = 128,
    seed: int = 0,
    device: Union[str, torch.device, None] = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Small synthetic batch for dry runs (the JAX package's numbers for the
    same seed), on ``device``: CUDA unless the caller asks for the CPU."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    waves = np.full((n_events, wave_length), 1000.0)
    waves += rng.normal(0, 3, size=waves.shape)
    starts = rng.integers(30, 60, n_events)
    widths = rng.integers(4, 40, n_events)
    for i in range(n_events):
        waves[i, starts[i] : starts[i] + widths[i]] -= 200
    waves = np.round(waves).astype(np.int16)
    event_length = np.full(n_events, wave_length, np.int32)
    pol = np.full(n_events, -1, np.int8)
    return (torch.from_numpy(waves).to(dev), torch.from_numpy(event_length).to(dev),
            torch.from_numpy(pol).to(dev))
