"""Pulse-shape widths: edge-based rise/fall vs cumulative-integral quantiles.

    python -m waveformanalysis_tpu_torch.examples.waveform_width_example [--device cuda]

The port's counterpart of the JAX package's examples/waveform_width_example.py
(reference analog: examples/waveform_width_example.py). waveform_width
measures 10%->90% rise and 90%->10% fall around each detected peak
(per-hit); waveform_width_integral measures the window holding the central
80% of the pulse integral (per-event) -- the robust width for S1/S2-style
discrimination. Both run on ``--device`` (default ``cuda``; ``--device
cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict

import numpy as np

from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms


def gaussian_pulses(n: int, sigmas, wave_length: int = 256, seed: int = 3):
    rng = np.random.default_rng(seed)
    st = make_fake_st_waveforms(n_events=n, wave_length=wave_length,
                                pulse_height=0, polarity="positive")
    t = np.arange(wave_length)
    waves = np.full((n, wave_length), 1000.0)
    for i in range(n):
        sigma = sigmas[i % len(sigmas)]
        waves[i] += 300 * np.exp(-((t - 128) ** 2) / (2 * sigma**2))
    waves += rng.normal(0, 1.5, waves.shape)
    st["wave"] = np.round(waves).astype(np.int16)
    st["baseline"] = 1000.0
    return st


def main(device: str = "cuda") -> Dict[str, Any]:
    """Run the example; returns the mean widths per sigma it printed."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HitFinderPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.waveform_width import WaveformWidthPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.waveform_width_integral import (
        WaveformWidthIntegralPlugin,
    )

    sigmas = (4.0, 20.0)
    out: Dict[str, Any] = {}
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False, "device": device})
        print(f"device: {ctx.device}")
        ctx.register(HitFinderPlugin(), WaveformWidthPlugin(),
                     WaveformWidthIntegralPlugin())
        ctx.set_config({"hit": {"use_derivative": False, "height": 80.0,
                                "prominence": 50.0, "width": 2}})
        st = gaussian_pulses(64, sigmas)
        ctx.inject_data("r", "st_waveforms", st)

        widths = ctx.get_data("r", "waveform_width")
        qwidths = ctx.get_data("r", "waveform_width_integral")

        rid = np.asarray(widths["record_id"])
        total = np.asarray(widths["total_width"])
        for k, sigma in enumerate(sigmas):
            sel = rid % len(sigmas) == k
            qsel = np.asarray(qwidths["event_index"]) % len(sigmas) == k
            edge = float(total[sel].mean())
            integral = float(np.asarray(qwidths["width"])[qsel].mean())
            print(f"sigma={sigma:5.1f} samples: edge width "
                  f"{edge:7.1f} ns, integral-quantile width "
                  f"{integral:7.1f} ns")
            out[sigma] = {"edge": edge, "integral": integral}
        ctx.flush_saves()
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
