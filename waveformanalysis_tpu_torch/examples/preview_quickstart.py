"""Preview a few raw events without running the pipeline.

    python -m waveformanalysis_tpu_torch.examples.preview_quickstart [--device cuda]

The port's counterpart of the JAX package's examples/preview_quickstart.py
(reference analog: examples/preview_quickstart.md, utils/preview.py).
WaveformPreviewer reads only as many files as needed, structures minimally,
and gives quick feature estimates -- the "look before you process" tool.
It reads files on the host; ``--device`` (default ``cuda``, which raises
without a card; ``--device cpu`` on the CPU) is resolved and printed as in
the other examples.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict


def main(device: str = "cuda") -> Dict[str, Any]:
    """Run the quickstart; returns the counts and features it printed."""
    from waveformanalysis_tpu_torch.device import resolve_device
    from waveformanalysis_tpu_torch.testing.fixtures import make_synthetic_vx2730_run
    from waveformanalysis_tpu_torch.utils.preview import WaveformPreviewer

    print(f"device: {resolve_device(device)}")
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_vx2730_run(tmp, run_name="run_001", n_channels=2,
                                  n_files_per_channel=3, n_rows=50)

        pv = WaveformPreviewer(tmp, "run_001", daq_adapter="vx2730")

        events = pv.load_events(channel=0, start=0, n_events=8)
        print(f"loaded {len(events)} events, wave length "
              f"{events['wave'].shape[1]}")

        feats = pv.preview_features(events)
        for i in range(len(events)):
            print(f"  event {i}: height {feats['height'][i]:.0f} ADC, "
                  f"area {feats['area'][i]:.0f}")

        # time-windowed load: events in the first 200 us (ps units)
        windowed = pv.load_by_timestamp(channel=1, start_ps=0,
                                        end_ps=200_000_000)
        print(f"channel 1 events in the first 200 us: {len(windowed)}")
    return {"events": len(events), "wave_length": int(events["wave"].shape[1]),
            "height": feats["height"], "area": feats["area"], "windowed": len(windowed)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
