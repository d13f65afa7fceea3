"""File-level parallel parsing utilities.

Behavioral analog of the reference IO utilities
(reference: waveform_analysis/utils/io.py:400-944): ``parse_and_stack_files``
parses every raw file in one flat thread pool and stacks results per channel;
``parse_files_generator`` yields parsed arrays incrementally.

Port of ``waveformanalysis_tpu/utils/io.py``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from waveformanalysis_tpu_torch.execution.manager import parallel_map

logger = logging.getLogger(__name__)


def _reader_for(daq_adapter: Optional[str]):
    from waveformanalysis_tpu_torch.formats.adapter import get_adapter

    return get_adapter(daq_adapter or "vx2730").format_reader


def parse_and_stack_files(
    raw_files: Sequence[Sequence[Union[str, Path]]],
    daq_adapter: Optional[str] = "vx2730",
    n_jobs: Optional[int] = None,
    show_progress: bool = False,
    parse_engine: Optional[str] = None,
) -> List[Optional[np.ndarray]]:
    """Parse per-channel file lists and vertically stack each channel.

    Files across ALL channels parse in one flat pool (the reference's
    file-level flattening, io.py:482), then group back by channel.
    Returns one stacked array per channel (None when a channel is empty).
    """
    reader = _reader_for(daq_adapter)
    tasks: List[Tuple[int, int, Union[str, Path]]] = []
    for ch_idx, files in enumerate(raw_files):
        for f_idx, f in enumerate(files or []):
            tasks.append((ch_idx, f_idx, f))
    if not tasks:
        return [None] * len(raw_files)

    def parse(task: Tuple[int, int, Union[str, Path]]):
        ch_idx, f_idx, path = task
        kwargs = {}
        if parse_engine and parse_engine != "auto":
            kwargs["parse_engine"] = parse_engine
        try:
            arr = reader.read_file(path, is_first_file=(f_idx == 0), **kwargs)
        except TypeError:
            arr = reader.read_file(path, is_first_file=(f_idx == 0))
        return ch_idx, f_idx, arr

    results = parallel_map(
        parse, tasks,
        max_workers=n_jobs or min(len(tasks), 16),
        show_progress=show_progress, name="parse_files",
    )
    grouped: Dict[int, Dict[int, np.ndarray]] = {}
    for ch_idx, f_idx, arr in results:
        grouped.setdefault(ch_idx, {})[f_idx] = arr

    stacked: List[Optional[np.ndarray]] = []
    for ch_idx in range(len(raw_files)):
        parts = grouped.get(ch_idx)
        if not parts:
            stacked.append(None)
            continue
        arrs = [parts[i] for i in sorted(parts) if parts[i].size > 0]
        stacked.append(np.vstack(arrs) if arrs else None)
    return stacked


def parse_files_generator(
    raw_files: Sequence[Sequence[Union[str, Path]]],
    daq_adapter: Optional[str] = "vx2730",
    chunk_files: int = 10,
) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (channel_index, stacked_array) per group of chunk_files files."""
    reader = _reader_for(daq_adapter)
    for ch_idx, files in enumerate(raw_files):
        files = list(files or [])
        for lo in range(0, len(files), chunk_files):
            group = files[lo : lo + chunk_files]
            arrs = [
                reader.read_file(f, is_first_file=(lo == 0 and i == 0))
                for i, f in enumerate(group)
            ]
            arrs = [a for a in arrs if a.size]
            if arrs:
                yield ch_idx, np.vstack(arrs)


def count_rows(
    raw_files: Sequence[Sequence[Union[str, Path]]],
    daq_adapter: Optional[str] = "vx2730",
) -> List[int]:
    """Per-channel total record counts honoring the header policy."""
    reader = _reader_for(daq_adapter)
    return [reader.count_total_rows(list(files or [])) for files in raw_files]
