"""Configurable generic CSV reader for custom formats.

Behavioral analog of the reference GenericCSVReader
(reference: waveform_analysis/utils/formats/generic.py:34): a fully
spec-driven delimited-text reader plus a helper to assemble a custom adapter
from a spec + layout description.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from waveformanalysis_tpu_torch.foundation.units import TimestampUnit
from waveformanalysis_tpu_torch.formats.adapter import DAQAdapter, register_adapter
from waveformanalysis_tpu_torch.formats.base import (
    ColumnMapping,
    FormatSpec,
    RawTimestampMode,
)
from waveformanalysis_tpu_torch.formats.directory import DirectoryLayout
from waveformanalysis_tpu_torch.formats.vx2730 import VX2730Reader


class GenericCSVReader(VX2730Reader):
    """Delimited-text reader driven entirely by its FormatSpec."""

    def __init__(self, spec: FormatSpec, parse_engine: str = "auto") -> None:
        super().__init__(spec, parse_engine=parse_engine)


def make_generic_adapter(
    name: str,
    delimiter: str = ",",
    timestamp_unit: str = "ps",
    timestamp_mode: str = "unit",
    sampling_rate_hz: Optional[float] = None,
    columns: Optional[Dict[str, Any]] = None,
    header_rows_first_file: int = 0,
    header_rows_other_files: int = 0,
    file_glob_pattern: str = "*CH*.csv",
    channel_regex: str = r"CH(\d+)",
    file_index_regex: str = r"_(\d+)\.csv$",
    raw_subdir: str = "RAW",
    register: bool = True,
) -> DAQAdapter:
    """Build (and by default register) an adapter for a custom CSV format."""
    spec = FormatSpec(
        name=name,
        columns=ColumnMapping(**(columns or {})),
        timestamp_unit=TimestampUnit(timestamp_unit),
        raw_timestamp_mode=RawTimestampMode(timestamp_mode),
        file_pattern=file_glob_pattern,
        header_rows_first_file=header_rows_first_file,
        header_rows_other_files=header_rows_other_files,
        delimiter=delimiter,
        sampling_rate_hz=sampling_rate_hz,
    )
    layout = DirectoryLayout(
        name=name,
        raw_subdir=raw_subdir,
        file_glob_pattern=file_glob_pattern,
        file_extension="",
        channel_regex=channel_regex,
        file_index_regex=file_index_regex,
    )
    adapter = DAQAdapter(
        name=name, format_reader=GenericCSVReader(spec), directory_layout=layout
    )
    if register:
        register_adapter(adapter)
    return adapter
