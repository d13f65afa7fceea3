"""Dual-baseline example: computed baseline vs upstream-provided baseline.

    python -m waveformanalysis_tpu_torch.examples.dual_baseline_example [--device cuda]

The port's counterpart of the JAX package's examples/dual_baseline_example.py
(reference analog: examples/dual_baseline_example.py -- BASELINE config #5
ingredient). st_waveforms carries BOTH a window-computed ``baseline`` and
an optional ``baseline_upstream``; feature plugins can also override per
channel with fixed baselines. The features run on ``--device`` (default
``cuda``; ``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms


def main(device: str = "cuda") -> Dict[str, Any]:
    """Run the example; returns the two mean heights and the keys."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import BasicFeaturesPlugin

    st = make_fake_st_waveforms(n_events=100, wave_length=256,
                                pulse_start=80, pulse_width=10,
                                pulse_height=150, noise_rms=2.0)
    # upstream baseline: e.g. from a dedicated baseline-tracking plugin
    st["baseline_upstream"] = st["baseline"] + 5.0

    ctx = Context(config={"show_progress": False, "device": device})
    print(f"device: {ctx.device}")
    ctx.register(BasicFeaturesPlugin())
    ctx.set_config({"basic_features": {"height_range": (0, None)}})
    ctx.inject_data("demo", "st_waveforms", st)

    # 1) features with the computed baseline
    computed = ctx.get_data("demo", "basic_features")
    h_computed = float(np.asarray(computed["height"]).mean())
    key_computed = ctx.key_for("demo", "basic_features")

    # 2) per-channel fixed-baseline override via channel_config
    ctx.set_config({"basic_features": {
        "height_range": (0, None),
        "channel_config": {"channels": {"0:0": {"fixed_baseline": 1100.0},
                                        "0:1": {"fixed_baseline": 1100.0}}},
    }})
    overridden = ctx.get_data("demo", "basic_features")
    h_overridden = float(np.asarray(overridden["height"]).mean())
    key_overridden = ctx.key_for("demo", "basic_features")

    print(f"height with computed baseline:  {h_computed:.1f} (expected ~150)")
    print(f"height with fixed 1100 baseline: {h_overridden:.1f} "
          f"(expected ~{150 + 100})")
    print("note: the config change produced a different cache key:")
    print(" ", key_overridden)
    return {"h_computed": h_computed, "h_overridden": h_overridden,
            "keys": (key_computed, key_overridden)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
