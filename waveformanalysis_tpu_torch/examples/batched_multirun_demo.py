"""Multi-run batched dispatch: the batch dimension as the parallel axis.

    python -m waveformanalysis_tpu_torch.examples.batched_multirun_demo [--device cuda]

The port's counterpart of the JAX package's examples/batched_multirun_demo.py.
The reference fans runs over host process pools; here the runs are
concatenated on the event axis and share ONE fused device program -- one
upload, one launch of each kernel, one copy back
(reference analog: core/data/batch_processor.py:197). Runs on ``--device``
(default ``cuda``; ``--device cpu`` runs the plain versions on the CPU).
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np


def make_run(n_events: int, seed: int):
    from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms

    st = make_fake_st_waveforms(
        n_events=n_events, wave_length=128, pulse_height=300,
        polarity="positive", noise_rms=3.0, seed=seed,
    )
    st["channel"] = (np.arange(n_events) % 2).astype(np.int16)
    return st


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the demo; returns the sizes it printed."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device of the fused program (default cuda)")
    parser.add_argument("--runs", type=int, default=6)
    parser.add_argument("--events", type=int, default=512, help="events per run")
    args = parser.parse_args(argv)

    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.data.batch_processor import BatchProcessor
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import (
        BasicFeaturesPlugin,
    )
    from waveformanalysis_tpu_torch.plugins.builtin.dataframe import DataFramePlugin
    from waveformanalysis_tpu_torch.plugins.builtin.event_analysis import (
        GroupedEventsPlugin,
    )
    from waveformanalysis_tpu_torch.plugins.builtin.hit_finder import ThresholdHitPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HitFinderPlugin

    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp,
                      config={"show_progress": False, "device": args.device})
        print(f"device: {ctx.device}")
        ctx.register(BasicFeaturesPlugin(), HitFinderPlugin(),
                     ThresholdHitPlugin(), DataFramePlugin(),
                     GroupedEventsPlugin())
        ctx.set_config({"hit": {"use_filtered": False, "use_derivative": False,
                                "height": 100.0, "prominence": 50.0,
                                "width": 2}})

        run_ids = [f"run_{i:03d}" for i in range(args.runs)]
        for i, rid in enumerate(run_ids):
            ctx.inject_data(rid, "st_waveforms", make_run(args.events, seed=i))

        # direct API: several targets, several runs, jointly planned
        t0 = time.perf_counter()
        out = ctx.get_data_batched(run_ids, ["basic_features", "hit"])
        dt = time.perf_counter() - t0
        total = sum(len(out[r]["basic_features"]) for r in run_ids)
        print(f"batched {len(run_ids)} runs / {total} events in {dt:.2f}s "
              f"-> {total / dt / 1e3:.1f}k ev/s")
        peaks = {rid: len(out[rid]["hit"]) for rid in run_ids}
        for rid in run_ids[:2]:
            print(f"  {rid}: {peaks[rid]} peaks")

        # BatchProcessor front-end: same dispatch, RunResult bookkeeping
        bp = BatchProcessor(ctx, executor_type="device")
        res = bp.process_runs(run_ids, "df_events")
        print(res.summary())
        ctx.flush_saves()
        return {"events": total, "peaks": peaks, "succeeded": sorted(res.succeeded),
                "batched_programs": ctx.profiler.stats()
                ["fusion.wave_chain.compute_many"]["count"]}


if __name__ == "__main__":
    main()
