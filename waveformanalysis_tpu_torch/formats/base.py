"""DAQ format abstractions: specs, column mappings, readers.

Behavioral analog of the reference format layer
(reference: waveform_analysis/utils/formats/base.py:67-447): a FormatSpec
describes column layout, native timestamp unit/semantics, header policy and
delimiter; FormatReader implements file reading. The framework-wide contract
is unchanged: ``timestamp`` normalizes to picoseconds, sample-index
timestamps multiply by dt_ps.
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

from waveformanalysis_tpu_torch.foundation.units import TimestampUnit

PathLike = Union[str, Path]


class RawTimestampMode(enum.Enum):
    """Native timestamp semantics: a physical unit or a sample index."""

    UNIT = "unit"
    SAMPLE_INDEX = "sample_index"


# NOTE on similarity to the reference format layer: ColumnMapping's indices,
# the TimestampUnit scale tables, and FormatSpec's field set are DAQ
# *hardware/file-format contract constants* (which CSV column holds what,
# how native ticks scale to ns/ps, header/delimiter policy). They must equal
# the reference's values to read the same instrument files; the reader logic
# around them (whole-buffer parsing, streaming structurizers) is original.


@dataclass
class ColumnMapping:
    """CSV column indices for DAQ records (instrument file-format contract)."""

    board: int = 0
    channel: int = 1
    timestamp: int = 2
    samples_start: int = 7
    samples_end: Optional[int] = None  # None -> to end of row
    baseline_start: int = 7
    baseline_end: int = 47


# unit-scale contract tables (must match the reference's conversions exactly)
_TO_NS = {
    TimestampUnit.PICOSECONDS: 1e-3,
    TimestampUnit.NANOSECONDS: 1.0,
    TimestampUnit.MICROSECONDS: 1e3,
    TimestampUnit.MILLISECONDS: 1e6,
    TimestampUnit.SECONDS: 1e9,
}

_TO_PS = {
    TimestampUnit.PICOSECONDS: 1.0,
    TimestampUnit.NANOSECONDS: 1e3,
    TimestampUnit.MICROSECONDS: 1e6,
    TimestampUnit.MILLISECONDS: 1e9,
    TimestampUnit.SECONDS: 1e12,
}


@dataclass
class FormatSpec:
    """Complete description of one DAQ data format."""

    # field set = the reference's format-declaration surface (adapters on
    # both sides declare VX2730/V1725 with these exact knobs)
    name: str
    version: str = "1.0"
    columns: ColumnMapping = field(default_factory=ColumnMapping)
    timestamp_unit: TimestampUnit = TimestampUnit.PICOSECONDS
    raw_timestamp_mode: RawTimestampMode = RawTimestampMode.UNIT
    file_pattern: str = "*CH*.CSV"
    header_rows_first_file: int = 2
    header_rows_other_files: int = 0
    delimiter: str = ";"
    sampling_rate_hz: Optional[float] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    def get_timestamp_scale(self) -> float:
        """Multiplier: native timestamp -> nanoseconds."""
        return _TO_NS.get(self.timestamp_unit, 1.0)

    def get_timestamp_scale_to_ps(self) -> float:
        """Multiplier: native timestamp -> picoseconds."""
        return _TO_PS.get(self.timestamp_unit, 1.0)

    def get_default_dt_ps(self) -> int:
        if not self.sampling_rate_hz:
            raise ValueError(
                "sampling_rate_hz is required for sample-index timestamps"
            )
        return int(round(1e12 / float(self.sampling_rate_hz)))

    def normalize_timestamp_to_ps(
        self, timestamps: np.ndarray, dt_ns: Optional[int] = None
    ) -> np.ndarray:
        """Native timestamps -> int64 ps (the framework-wide unit)."""
        timestamps = np.asarray(timestamps, dtype=np.int64)
        if self.raw_timestamp_mode == RawTimestampMode.SAMPLE_INDEX:
            dt_ps = int(dt_ns) * 1000 if dt_ns is not None else self.get_default_dt_ps()
            return timestamps * np.int64(dt_ps)
        scale = self.get_timestamp_scale_to_ps()
        if scale == 1.0:
            return timestamps
        if float(scale).is_integer():
            return timestamps * int(scale)
        return (timestamps.astype(np.float64) * scale).astype(np.int64)


class FormatReader(abc.ABC):
    """Reads raw DAQ files into 2-D row arrays (or structured arrays for
    binary formats)."""

    def __init__(self, spec: FormatSpec) -> None:
        self.spec = spec

    @abc.abstractmethod
    def read_file(self, file_path: PathLike, is_first_file: bool = True) -> np.ndarray:
        """Read one file into a row-per-record array."""

    def read_files(
        self,
        file_paths: List[PathLike],
        show_progress: bool = False,
        **kwargs: Any,
    ) -> np.ndarray:
        """Read and vertically stack multiple files."""
        parts = []
        for i, fp in enumerate(file_paths):
            arr = self.read_file(fp, is_first_file=(i == 0))
            if arr.size:
                parts.append(arr)
        if not parts:
            return np.array([]).reshape(0, 0)
        return np.vstack(parts) if parts[0].ndim == 2 else np.concatenate(parts)

    def read_files_generator(
        self,
        file_paths: List[PathLike],
        chunk_size: int = 10,
        **kwargs: Any,
    ) -> Iterator[np.ndarray]:
        """Yield stacked arrays for groups of ``chunk_size`` files."""
        for i in range(0, len(file_paths), chunk_size):
            group = file_paths[i : i + chunk_size]
            arrs = [
                self.read_file(fp, is_first_file=(i == 0 and j == 0))
                for j, fp in enumerate(group)
            ]
            arrs = [a for a in arrs if a.size]
            if not arrs:
                continue
            yield np.vstack(arrs) if arrs[0].ndim == 2 else np.concatenate(arrs)

    def count_total_rows(self, file_paths: List[PathLike]) -> int:
        """Total record count honoring the header policy."""
        total = 0
        for idx, fp in enumerate(file_paths):
            p = Path(fp)
            if not p.exists() or p.stat().st_size == 0:
                continue
            skip = (
                self.spec.header_rows_first_file
                if idx == 0
                else self.spec.header_rows_other_files
            )
            with open(p, "rb") as fh:
                lines = sum(1 for _ in fh)
            total += max(0, lines - skip)
        return total

    def read_files_streaming(
        self,
        file_paths: List[PathLike],
        output_dtype: np.dtype,
        output_path: Path,
        structurizer: Callable[[np.ndarray, np.memmap, int], int],
        show_progress: bool = False,
        **kwargs: Any,
    ) -> np.memmap:
        """Stream files through ``structurizer`` into a preallocated memmap."""
        if not file_paths:
            return np.memmap(output_path, dtype=output_dtype, mode="w+", shape=(0,))
        total = self.count_total_rows(file_paths)
        out = np.memmap(output_path, dtype=output_dtype, mode="w+", shape=(max(total, 1),))
        offset = 0
        for idx, fp in enumerate(file_paths):
            arr = self.read_file(fp, is_first_file=(idx == 0))
            if arr.size == 0:
                continue
            offset += int(structurizer(arr, out, offset))
        out.flush()
        if offset < total or total == 0:
            return np.memmap(output_path, dtype=output_dtype, mode="r+", shape=(offset,))
        return out

    def extract_columns(self, data: np.ndarray) -> Dict[str, np.ndarray]:
        """Split a raw row array into board/channel/timestamp/samples/baseline."""
        if data.size == 0:
            return {
                "board": np.array([], dtype=int),
                "channel": np.array([], dtype=int),
                "timestamp": np.array([], dtype=np.int64),
                "samples": np.array([]).reshape(0, 0),
                "baseline": np.array([], dtype=float),
            }
        cols = self.spec.columns
        samples_end = cols.samples_end if cols.samples_end is not None else data.shape[1]
        baseline_data = data[:, cols.baseline_start : cols.baseline_end].astype(float)
        return {
            "board": data[:, cols.board].astype(int),
            "channel": data[:, cols.channel].astype(int),
            "timestamp": data[:, cols.timestamp].astype(np.int64),
            "samples": data[:, cols.samples_start : samples_end].astype(float),
            "baseline": np.mean(baseline_data, axis=1),
        }

    def convert_timestamp_to_ns(self, timestamps: np.ndarray) -> np.ndarray:
        scale = self.spec.get_timestamp_scale()
        if scale == 1.0:
            return np.asarray(timestamps, dtype=np.int64)
        return (np.asarray(timestamps) * scale).astype(np.int64)

    def convert_timestamp_to_ps(self, timestamps: np.ndarray) -> np.ndarray:
        scale = self.spec.get_timestamp_scale_to_ps()
        if scale == 1.0:
            return np.asarray(timestamps, dtype=np.int64)
        return (np.asarray(timestamps) * scale).astype(np.int64)

    def validate_data(self, data: np.ndarray) -> bool:
        if data.size == 0:
            return True
        cols = self.spec.columns
        min_cols = max(cols.board, cols.channel, cols.timestamp, cols.samples_start) + 1
        if data.ndim == 2 and data.shape[1] < min_cols:
            raise ValueError(
                f"Data has too few columns: expected >= {min_cols}, got {data.shape[1]}"
            )
        return True
