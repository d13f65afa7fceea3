"""Minimal end-to-end example: synthetic waveforms -> basic features.

    python -m waveformanalysis_tpu_torch.examples.signal_processing_example [--device cuda]

The port's counterpart of the JAX package's
examples/signal_processing_example.py (reference analog:
examples/signal_processing_example.py -- BASELINE config #1). The features
run on ``--device`` (default ``cuda``, which raises without a card;
``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms


def main(device: str = "cuda") -> Dict[str, Any]:
    """Run the example; returns the numbers it printed."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import BasicFeaturesPlugin

    # 1. Synthetic structured waveforms: 1000 events, 256 samples,
    #    negative-going pulses of height 200 over a 1000-ADC baseline.
    st_waveforms = make_fake_st_waveforms(
        n_events=1000, wave_length=256,
        pulse_start=80, pulse_width=12, pulse_height=200,
        noise_rms=3.0,
    )

    # 2. A Context over temporary storage with the features plugin.
    ctx = Context(config={"show_progress": True, "device": device})
    print(f"device: {ctx.device}")
    ctx.register(BasicFeaturesPlugin())
    ctx.set_config({"basic_features": {"height_range": (0, None)}})
    ctx.inject_data("demo_run", "st_waveforms", st_waveforms)

    # 3. One call computes (on device), caches, and returns the features.
    features = ctx.get_data("demo_run", "basic_features")

    heights = np.asarray(features["height"])
    areas = np.asarray(features["area"])
    key = ctx.key_for("demo_run", "basic_features")
    print(f"events:        {len(features)}")
    print(f"mean height:   {heights.mean():.1f} ADC (expected ~200)")
    print(f"mean area:     {areas.mean():.1f} ADC*samples (expected ~2400)")
    print(f"cache key:     {key}")

    # 4. A second request is a cache hit (memory, then disk across restarts).
    _ = ctx.get_data("demo_run", "basic_features")
    stats = ctx.cache_stats()
    print(f"cache stats:   {stats}")
    return {"events": len(features), "mean_height": float(heights.mean()),
            "mean_area": float(areas.mean()), "key": key, "cache_stats": stats}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
