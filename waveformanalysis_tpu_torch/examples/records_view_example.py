"""Minimal RecordsView usage: per-record wave access over the shared pool.

    python -m waveformanalysis_tpu_torch.examples.records_view_example [--device cuda]

The port's counterpart of the JAX package's examples/records_view_example.py
(reference analog: examples/records_view.py). Records keep variable-length
waveforms in one contiguous pool addressed by (wave_offset, event_length);
RecordsView gives per-record reads, baseline correction, window slices and
padded matrices -- on the host, or gathered on ``--device`` (default
``cuda``; ``--device cpu`` runs it on the CPU) -- without copying the pool.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the example; returns the sizes it printed."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device of the padded gather (default cuda)")
    args = parser.parse_args(argv)

    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.data.query import TimeRangeQueryEngine
    from waveformanalysis_tpu_torch.data.records_view import RecordsView
    from waveformanalysis_tpu_torch.plugins.builtin.records import (
        RecordsPlugin,
        WavePoolPlugin,
    )
    from waveformanalysis_tpu_torch.plugins.builtin.waveforms import (
        RawFileNamesPlugin,
        WaveformsPlugin,
    )
    from waveformanalysis_tpu_torch.testing.fixtures import make_synthetic_vx2730_run

    with tempfile.TemporaryDirectory() as tmp:
        daq_root = str(Path(tmp) / "daq")
        make_synthetic_vx2730_run(daq_root, run_name="run_001",
                                  n_channels=2, n_rows=64, n_samples=48)

        ctx = Context(
            storage_dir=str(Path(tmp) / "store"),
            config={"data_root": daq_root, "daq_adapter": "vx2730",
                    "n_channels": 2, "show_progress": False, "device": args.device},
        )
        print(f"device: {ctx.device}")
        ctx.register(RawFileNamesPlugin(), WaveformsPlugin(),
                     RecordsPlugin(), WavePoolPlugin())

        records = ctx.get_data("run_001", "records")
        pool = ctx.get_data("run_001", "wave_pool")
        rv = RecordsView(records, pool)
        print(f"records={len(rv)}")

        first_record_id = int(records["record_id"][0])
        wave0 = rv.waves(first_record_id)
        signal0 = rv.signals(first_record_id, window=(0, 10))
        print("record_id=", first_record_id)
        print("wave0 head:", wave0[:10])
        print("signal0 head:", signal0[:10])
        print("baseline:", rv.baseline(first_record_id))

        # the padded matrix, gathered on the device from one pool upload
        waves_d, lengths_d = rv.padded_wave_matrix_device(device=ctx.device)
        waves_h, _ = rv.padded_wave_matrix()
        same = bool(np.array_equal(waves_d.cpu().numpy(), waves_h))
        print(f"padded matrix {tuple(waves_d.shape)} on {waves_d.device}: "
              f"{'=' if same else '!='} the host gather")

        # time-window subsetting via the query engine (half-open [lo, hi))
        engine = TimeRangeQueryEngine(ctx)
        lo = int(records["timestamp"].min())
        hi = lo + 1_000_000
        subset = engine.query_time_range("run_001", "records",
                                         start=lo, end=hi,
                                         time_field="timestamp")
        print(f"subset={len(subset)} rows in [{lo}, {hi})")
        ctx.flush_saves()
    return {"records": len(rv), "padded": tuple(waves_d.shape), "same": same,
            "subset": len(subset)}


if __name__ == "__main__":
    main()
