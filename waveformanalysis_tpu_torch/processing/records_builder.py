"""Records construction helpers.

Port of part of ``waveformanalysis_tpu/processing/records_builder.py``: for
now only :func:`resolve_baseline_window`, which the st_waveforms plugin
uses. The records table and wave_pool build come with ROADMAP.md Queue 1,
item 4 (records).
"""

from __future__ import annotations

from typing import Tuple, Union


def resolve_baseline_window(
    baseline_samples: Union[int, Tuple[int, int], list, None],
    samples_start: int,
    baseline_start: int,
    baseline_end: int,
) -> Tuple[int, int]:
    """Reference semantics (records_builder.py:94-106): None -> the format's
    baseline columns; int n -> first n sample columns; (a, b) -> sample-
    relative window."""
    if baseline_samples is None:
        return baseline_start, baseline_end
    if isinstance(baseline_samples, (tuple, list)) and len(baseline_samples) == 2:
        return (
            samples_start + int(baseline_samples[0]),
            samples_start + int(baseline_samples[1]),
        )
    return samples_start, samples_start + int(baseline_samples)
