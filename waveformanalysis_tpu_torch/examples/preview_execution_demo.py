"""preview_execution(): confirm the plan before running anything.

    python -m waveformanalysis_tpu_torch.examples.preview_execution_demo [--device cuda]

The port's counterpart of the JAX package's examples/preview_execution_demo.py
(reference analog: examples/demo_preview_execution.py). Shows the
execution plan, per-stage cache status (memory/disk/miss), the needed set,
and non-default config deltas -- with no computation. After one real
get_data on ``--device`` (default ``cuda``; ``--device cpu`` runs on the
CPU) the preview reflects the now-valid caches.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict

import numpy as np

from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms


def main(device: str = "cuda") -> Dict[str, Any]:
    """Run the demo; returns the plan, the cold and the warm stages."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.plugin_sets import cuda_default

    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False, "device": device})
        print(f"device: {ctx.device}")
        ctx.register(*cuda_default())
        ctx.set_config({
            "hit": {"height": 120.0, "prominence": 40.0},
            "df_paired": {"time_window_ns": 250.0},
        })
        st = make_fake_st_waveforms(n_events=64, wave_length=64,
                                    n_channels=2, pulse_start=20,
                                    pulse_width=6, pulse_height=250,
                                    noise_rms=2.0, seed=11)
        ctx.inject_data("run_001", "st_waveforms", st)

        # -- 1. basic preview: everything is a miss before the first run ---
        print("=" * 70)
        print("preview BEFORE computing (all stages miss)")
        print("=" * 70)
        result = ctx.preview_execution("run_001", "s1_s2", verbose=True)

        # -- 2. programmatic use -------------------------------------------
        plan = result["plan"]
        misses = [n for n, s in result["cache_status"].items() if s == "miss"]
        print(f"\nplan has {len(plan)} stages; {len(misses)} cold: {misses}")
        print("config deltas:",
              {k: sorted(v) for k, v in result["config_deltas"].items() if v})

        # -- 3. compute once, preview again: caches now valid ---------------
        out = ctx.get_data("run_001", "s1_s2")
        labels = np.asarray(out["label"])
        counts = {"rows": len(out), "n_s1": int(np.sum(labels == 1)),
                  "n_s2": int(np.sum(labels == 2))}
        print(f"\ncomputed s1_s2: {len(out)} rows "
              f"(S1={counts['n_s1']}, S2={counts['n_s2']})")
        ctx.flush_saves()

        print("\n" + "=" * 70)
        print("preview AFTER computing (stages served from cache)")
        print("=" * 70)
        result2 = ctx.preview_execution("run_001", "s1_s2", verbose=True)
        warm = [n for n, s in result2["cache_status"].items() if s != "miss"]
        print(f"\nwarm stages: {warm}")
    return {"plan": list(plan), "misses": misses, "warm": warm, "s1_s2": counts}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
