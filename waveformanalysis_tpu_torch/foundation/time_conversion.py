"""Relative <-> absolute time conversion.

Behavioral analog of the reference time-conversion layer
(reference: waveform_analysis/core/foundation/time_conversion.py:52,194,359):
an epoch anchors a run's relative timestamps (default ns) to wall-clock
datetimes; the extractor recovers epochs from filenames, CSV headers, file
mtimes, or explicit configuration. Conversions are vectorized over NumPy
arrays — device arrays are converted at the host boundary since datetimes
never live on the TPU.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from waveformanalysis_tpu_torch.foundation.units import TimestampUnit

_UNIT_TO_SECONDS = {
    TimestampUnit.PICOSECONDS: 1e-12,
    TimestampUnit.NANOSECONDS: 1e-9,
    TimestampUnit.MICROSECONDS: 1e-6,
    TimestampUnit.MILLISECONDS: 1e-3,
    TimestampUnit.SECONDS: 1.0,
}


@dataclass
class EpochInfo:
    """Epoch metadata anchoring a run's relative time axis.

    Attributes:
        epoch_timestamp: Unix timestamp (seconds, float).
        epoch_datetime: timezone-aware datetime (authoritative; timestamp is
            re-derived from it if inconsistent).
        epoch_source: one of "filename", "csv_header", "first_event",
            "file_ctime", "manual".
        time_unit: unit of the run's relative timestamps.
        timezone_name: IANA-ish name for display.
    """

    epoch_timestamp: float
    epoch_datetime: datetime
    epoch_source: str
    time_unit: TimestampUnit = TimestampUnit.NANOSECONDS
    timezone_name: str = "UTC"

    def __post_init__(self) -> None:
        if self.epoch_datetime.tzinfo is None:
            self.epoch_datetime = self.epoch_datetime.replace(tzinfo=timezone.utc)
            self.timezone_name = "UTC"
        expected = self.epoch_datetime.timestamp()
        if abs(self.epoch_timestamp - expected) > 1e-6:
            self.epoch_timestamp = expected

    @classmethod
    def from_datetime(
        cls,
        dt: datetime,
        source: str = "manual",
        time_unit: TimestampUnit = TimestampUnit.NANOSECONDS,
    ) -> "EpochInfo":
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return cls(
            epoch_timestamp=dt.timestamp(),
            epoch_datetime=dt,
            epoch_source=source,
            time_unit=time_unit,
            timezone_name=str(dt.tzinfo),
        )

    @classmethod
    def from_timestamp(
        cls,
        ts: float,
        source: str = "manual",
        time_unit: TimestampUnit = TimestampUnit.NANOSECONDS,
    ) -> "EpochInfo":
        dt = datetime.fromtimestamp(ts, tz=timezone.utc)
        return cls(
            epoch_timestamp=ts,
            epoch_datetime=dt,
            epoch_source=source,
            time_unit=time_unit,
            timezone_name="UTC",
        )

    @property
    def epoch_ns(self) -> int:
        """Epoch as integer nanoseconds since the Unix epoch."""
        return int(round(self.epoch_timestamp * 1e9))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "epoch_timestamp": self.epoch_timestamp,
            "epoch_datetime": self.epoch_datetime.isoformat(),
            "epoch_source": self.epoch_source,
            "time_unit": self.time_unit.value,
            "timezone_name": self.timezone_name,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "EpochInfo":
        return cls(
            epoch_timestamp=data["epoch_timestamp"],
            epoch_datetime=datetime.fromisoformat(data["epoch_datetime"]),
            epoch_source=data["epoch_source"],
            time_unit=TimestampUnit(data.get("time_unit", "ns")),
            timezone_name=data.get("timezone_name", "UTC"),
        )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"EpochInfo(datetime={self.epoch_datetime.isoformat()}, "
            f"source={self.epoch_source}, unit={self.time_unit.value})"
        )


class TimeConverter:
    """Vectorized relative <-> absolute time conversion around an epoch."""

    def __init__(self, epoch_info: EpochInfo) -> None:
        self.epoch_info = epoch_info
        self._scale_to_seconds = _UNIT_TO_SECONDS.get(epoch_info.time_unit, 1e-9)

    def relative_to_absolute(
        self, relative_time: Union[int, float, np.ndarray]
    ) -> Union[datetime, np.ndarray]:
        """Relative timestamp(s) -> datetime (scalar) or datetime64[ns] (array)."""
        if isinstance(relative_time, np.ndarray):
            rel_ns = (
                relative_time.astype(np.float64) * self._scale_to_seconds * 1e9
            ).astype(np.int64)
            epoch_ns = np.datetime64(self.epoch_info.epoch_ns, "ns")
            return epoch_ns + rel_ns.astype("timedelta64[ns]")
        seconds = float(relative_time) * self._scale_to_seconds
        return datetime.fromtimestamp(
            self.epoch_info.epoch_timestamp + seconds, tz=timezone.utc
        )

    def absolute_to_relative(
        self, absolute_time: Union[datetime, np.ndarray]
    ) -> Union[int, np.ndarray]:
        """Datetime(s) -> integer relative timestamp(s) in the epoch's unit."""
        if isinstance(absolute_time, np.ndarray):
            abs_ns = absolute_time.astype("datetime64[ns]").astype(np.int64)
            rel_ns = abs_ns - self.epoch_info.epoch_ns
            return (rel_ns / (self._scale_to_seconds * 1e9)).astype(np.int64)
        if absolute_time.tzinfo is None:
            absolute_time = absolute_time.replace(tzinfo=timezone.utc)
        delta_s = absolute_time.timestamp() - self.epoch_info.epoch_timestamp
        return int(round(delta_s / self._scale_to_seconds))

    def convert_time_range(
        self, start_dt: Optional[datetime], end_dt: Optional[datetime]
    ) -> Tuple[Optional[int], Optional[int]]:
        """Convert an absolute (start, end) query window to relative units."""
        start_rel = int(self.absolute_to_relative(start_dt)) if start_dt else None
        end_rel = int(self.absolute_to_relative(end_dt)) if end_dt else None
        return start_rel, end_rel


class EpochExtractor:
    """Extracts run epochs from filenames, CSV headers, or file metadata."""

    DEFAULT_FILENAME_PATTERNS: List[Tuple[str, str]] = [
        # ISO-ish: 2024-01-01_12-00-00 or 2024-01-01T12:00:00
        (r"(\d{4})-(\d{2})-(\d{2})[_T](\d{2})[:-](\d{2})[:-](\d{2})", "%Y-%m-%d %H:%M:%S"),
        # Compact: 20240101120000
        (r"(\d{4})(\d{2})(\d{2})(\d{2})(\d{2})(\d{2})", "%Y%m%d%H%M%S"),
        # Underscored: 2024_01_01_120000
        (r"(\d{4})_(\d{2})_(\d{2})_(\d{2})(\d{2})(\d{2})", "%Y_%m_%d_%H%M%S"),
        # Date only: 2024-01-01
        (r"(\d{4})-(\d{2})-(\d{2})", "%Y-%m-%d"),
        # Date only compact: 20240101
        (r"(\d{4})(\d{2})(\d{2})", "%Y%m%d"),
    ]

    DEFAULT_CSV_METADATA_KEYS = [
        "epoch",
        "start_time",
        "acquisition_start",
        "timestamp",
        "datetime",
    ]

    def __init__(
        self,
        filename_patterns: Optional[List[Tuple[str, str]]] = None,
        csv_metadata_keys: Optional[List[str]] = None,
    ) -> None:
        self.filename_patterns = filename_patterns or self.DEFAULT_FILENAME_PATTERNS
        self.csv_metadata_keys = csv_metadata_keys or self.DEFAULT_CSV_METADATA_KEYS

    def extract_from_filename(self, filename: Union[str, Path]) -> Optional[datetime]:
        """Try the filename patterns in priority order."""
        name = Path(filename).name
        for pattern, fmt in self.filename_patterns:
            m = re.search(pattern, name)
            if not m:
                continue
            groups = m.groups()
            try:
                if len(groups) == 6:
                    if fmt == "%Y-%m-%d %H:%M:%S":
                        text = f"{groups[0]}-{groups[1]}-{groups[2]} {groups[3]}:{groups[4]}:{groups[5]}"
                    elif fmt == "%Y%m%d%H%M%S":
                        text = "".join(groups)
                    else:
                        text = f"{groups[0]}_{groups[1]}_{groups[2]}_{groups[3]}{groups[4]}{groups[5]}"
                    dt = datetime.strptime(text, fmt)
                elif len(groups) == 3:
                    if fmt == "%Y-%m-%d":
                        dt = datetime.strptime("-".join(groups), fmt)
                    else:
                        dt = datetime.strptime("".join(groups), fmt)
                else:
                    continue
                return dt.replace(tzinfo=timezone.utc)
            except ValueError:
                continue
        return None

    def extract_from_csv_header(
        self, path: Union[str, Path], max_lines: int = 10
    ) -> Optional[datetime]:
        """Scan leading comment/header lines for a known metadata key."""
        try:
            with open(path, "r", errors="replace") as fh:
                for _ in range(max_lines):
                    line = fh.readline()
                    if not line:
                        break
                    lowered = line.lower()
                    for key in self.csv_metadata_keys:
                        if key in lowered:
                            dt = self._parse_datetime_fragment(line)
                            if dt is not None:
                                return dt
        except OSError:
            return None
        return None

    def extract_from_file_ctime(self, path: Union[str, Path]) -> Optional[datetime]:
        """Fall back to the file's creation/change time."""
        try:
            st = Path(path).stat()
            return datetime.fromtimestamp(st.st_ctime, tz=timezone.utc)
        except OSError:
            return None

    def auto_extract(
        self, files: Iterable[Union[str, Path]]
    ) -> Optional[EpochInfo]:
        """Pick the best available epoch source across a run's files."""
        files = list(files)
        for f in files:
            dt = self.extract_from_filename(f)
            if dt is not None:
                return EpochInfo.from_datetime(dt, source="filename")
        for f in files:
            dt = self.extract_from_csv_header(f)
            if dt is not None:
                return EpochInfo.from_datetime(dt, source="csv_header")
        for f in files:
            dt = self.extract_from_file_ctime(f)
            if dt is not None:
                return EpochInfo.from_datetime(dt, source="file_ctime")
        return None

    def _parse_datetime_fragment(self, text: str) -> Optional[datetime]:
        m = re.search(
            r"(\d{4})-(\d{2})-(\d{2})[ T](\d{2}):(\d{2}):(\d{2})", text
        )
        if m:
            try:
                return datetime.strptime(
                    " ".join([f"{m.group(1)}-{m.group(2)}-{m.group(3)}",
                              f"{m.group(4)}:{m.group(5)}:{m.group(6)}"]),
                    "%Y-%m-%d %H:%M:%S",
                ).replace(tzinfo=timezone.utc)
            except ValueError:
                return None
        m = re.search(r"\b(1[5-9]\d{8}|2\d{9})(?:\.\d+)?\b", text)
        if m:
            try:
                return datetime.fromtimestamp(float(m.group(0)), tz=timezone.utc)
            except (ValueError, OverflowError):
                return None
        return None
