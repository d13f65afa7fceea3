"""Records pipeline: raw DAQ CSV run -> records/wave_pool -> features -> df.

    python -m waveformanalysis_tpu_torch.examples.records_pipeline_example [--device cuda]

The port's counterpart of the JAX package's examples/records_pipeline_example.py
(reference analog: examples/records_pipeline_example.py). The records path
keeps variable-length waveforms in one contiguous pool addressed by
(wave_offset, event_length), so downstream plugins read from a single padded
matrix instead of per-file arrays. The device programs run on ``--device``
(default ``cuda``; ``--device cpu`` runs them on the CPU).
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the example; returns the row counts it printed."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device of the device programs (default cuda)")
    args = parser.parse_args(argv)

    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import BasicFeaturesPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.dataframe import DataFramePlugin
    from waveformanalysis_tpu_torch.plugins.builtin.records import RecordsPlugin, WavePoolPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.waveforms import (
        RawFileNamesPlugin,
        WaveformsPlugin,
    )
    from waveformanalysis_tpu_torch.testing.fixtures import make_synthetic_vx2730_run

    with tempfile.TemporaryDirectory() as tmp:
        daq_root = str(Path(tmp) / "daq")
        make_synthetic_vx2730_run(
            daq_root, run_name="run_001", n_channels=2,
            n_files_per_channel=2, n_rows=64, n_samples=48,
        )

        ctx = Context(
            storage_dir=str(Path(tmp) / "store"),
            config={"data_root": daq_root, "daq_adapter": "vx2730",
                    "show_progress": False, "device": args.device},
        )
        print(f"device: {ctx.device}")
        ctx.register(RawFileNamesPlugin(), WaveformsPlugin(), RecordsPlugin(),
                     WavePoolPlugin(), BasicFeaturesPlugin(), DataFramePlugin())
        # read features straight off the records pool (no st_waveforms pass)
        ctx.set_config({"basic_features": {"wave_source": "records"}})

        records = ctx.get_data("run_001", "records")
        pool = ctx.get_data("run_001", "wave_pool")
        print(f"records: {len(records)} rows across "
              f"{len(set(records['channel'].tolist()))} channels; "
              f"pool: {pool.shape[0]} samples")

        df = ctx.get_data("run_001", "df")
        print(df.head())
        print(f"mean area {df['area'].mean():.1f} ADC·samples, "
              f"mean height {df['height'].mean():.1f} ADC")
        ctx.flush_saves()
    return {"records": len(records), "pool": int(pool.shape[0]), "df": len(df)}


if __name__ == "__main__":
    main()
