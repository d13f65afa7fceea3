"""S1/S2 classification demo: mixed fast/slow pulses through the full chain.

    python -m waveformanalysis_tpu_torch.examples.s1_s2_pipeline_demo [--device cuda]

The port's counterpart of the JAX package's examples/s1_s2_pipeline_demo.py
(reference analog: examples/s1_s2_pipeline_demo.ipynb -- BASELINE config
#4). 400 events of 512 samples, alternating narrow (S1-like) and wide
(S2-like) pulses, go through hit -> waveform_width -> basic_features ->
s1_s2 on ``--device`` (default ``cuda``, which raises without a card;
``--device cpu`` runs on the CPU), and the labels are scored against the
truth.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms


def make_mixed_pulses(n_events: int = 400, wave_length: int = 512, seed: int = 7):
    """Alternating narrow (S1-like, sigma=3) and wide (S2-like, sigma=25)
    positive Gaussians."""
    rng = np.random.default_rng(seed)
    st = make_fake_st_waveforms(n_events=n_events, wave_length=wave_length,
                                pulse_height=0, polarity="positive")
    t = np.arange(wave_length)
    waves = np.full((n_events, wave_length), 1000.0)
    truth = np.empty(n_events, dtype=np.int8)
    for i in range(n_events):
        center = rng.integers(100, 400)
        if i % 2 == 0:
            waves[i] += 400 * np.exp(-((t - center) ** 2) / (2 * 3.0**2))
            truth[i] = 1  # S1
        else:
            waves[i] += 250 * np.exp(-((t - center) ** 2) / (2 * 25.0**2))
            truth[i] = 2  # S2
    waves += rng.normal(0, 2, waves.shape)
    st["wave"] = np.round(waves).astype(np.int16)
    st["baseline"] = 1000.0
    return st, truth


def main(device: str = "cuda") -> Dict[str, Any]:
    """Run the demo; returns the counts and the accuracy it printed."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import BasicFeaturesPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HitFinderPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.s1_s2_classifier import (
        S1S2ClassifierPlugin,
    )
    from waveformanalysis_tpu_torch.plugins.builtin.waveform_width import WaveformWidthPlugin

    st, truth = make_mixed_pulses()

    ctx = Context(config={"show_progress": True, "device": device})
    print(f"device: {ctx.device}")
    ctx.register(HitFinderPlugin(), WaveformWidthPlugin(),
                 BasicFeaturesPlugin(), S1S2ClassifierPlugin())
    ctx.set_config({
        "hit": {"use_derivative": False, "height": 80.0,
                "prominence": 50.0, "width": 2},
        "basic_features": {"height_range": (0, None)},
        "s1_s2": {
            "width_unit": "samples",
            "s1_width_range": (0, 30),
            "s2_width_range": (40, 400),
        },
    })
    ctx.inject_data("demo", "st_waveforms", st)

    result = ctx.get_data("demo", "s1_s2")
    labels = np.asarray(result["label"])
    rid = np.asarray(result["record_id"])
    accuracy = float(np.mean(labels == truth[rid]))

    n_s1 = int(np.sum(labels == 1))
    n_s2 = int(np.sum(labels == 2))
    print(f"classified peaks: {len(result)}")
    print(f"S1: {n_s1}   S2: {n_s2}   unknown: {len(result) - n_s1 - n_s2}")
    print(f"accuracy vs truth: {accuracy:.3f}")
    return {"peaks": len(result), "n_s1": n_s1, "n_s2": n_s2, "accuracy": accuracy}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
