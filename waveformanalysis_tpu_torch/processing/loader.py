"""Raw-file discovery for runs.

Behavioral analog of the reference loader
(reference: waveform_analysis/core/processing/loader.py:286): returns a
``List[List[str]]`` of file paths grouped by channel (list index = channel
position after optional start_channel/n_channels slicing), sourced from a
DAQRun object, a registered adapter scan, or a filesystem walk.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

logger = logging.getLogger(__name__)


def get_raw_files(
    run_name: str,
    data_root: str = "DAQ",
    daq_run: Optional[Any] = None,
    daq_adapter: Optional[str] = "vx2730",
    n_channels: Optional[int] = None,
    start_channel: int = 0,
) -> List[List[str]]:
    """Per-channel ordered raw-file lists for a run."""
    groups = None

    if daq_run is not None and hasattr(daq_run, "get_channel_files"):
        try:
            groups = {
                ch: [str(p) for p in files]
                for ch, files in daq_run.get_channel_files().items()
            }
        except Exception as e:
            logger.warning("DAQRun file listing failed: %s", e)
            groups = None

    if groups is None and daq_adapter:
        from waveformanalysis_tpu_torch.formats.adapter import get_adapter

        adapter = get_adapter(daq_adapter)
        # a missing run directory is an error, matching the reference
        # (reference: processing/loader.py:169 raises FileNotFoundError);
        # an existing-but-empty run yields an empty list
        scan = adapter.scan_run(data_root, run_name)
        groups = {ch: [str(p) for p in files] for ch, files in scan.items()}

    if not groups:
        return []

    channels = sorted(groups)
    if start_channel:
        channels = [c for c in channels if c >= start_channel]
    if n_channels is not None:
        channels = channels[:n_channels]
    return [groups[c] for c in channels]
