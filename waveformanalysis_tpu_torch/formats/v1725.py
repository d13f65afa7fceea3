"""CAEN V1725 DAW_DEMO binary adapter (250 MHz, sample-index timestamps).

Behavioral analog of the reference V1725 adapter
(reference: waveform_analysis/utils/formats/v1725.py:26-281). Wire format:

- event header: 16 bytes; active-channel mask = byte4 | (byte11 << 8);
- per active channel, a 12-byte channel header:
  * bits 0-21 of the first 3 bytes: channel record size in 32-bit words
    (including the 3 header words),
  * bit 6 of byte 3: truncation flag,
  * bytes 4-9: 48-bit little-endian timestamp (sample index),
  * bytes 10-11: 16-bit baseline;
- followed by (size-3)*4 bytes of little-endian int16 samples.

Board id comes from the filename (``_b(\\d+)``). This implementation parses
from one whole-file buffer with offset walking (no per-read syscalls) —
measurably faster than a read()-per-field loop; a C++ decoder can slot in
behind the same interface later.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from waveformanalysis_tpu_torch.foundation.units import TimestampUnit
from waveformanalysis_tpu_torch.formats.adapter import DAQAdapter, register_adapter
from waveformanalysis_tpu_torch.formats.base import (
    ColumnMapping,
    FormatReader,
    FormatSpec,
    PathLike,
    RawTimestampMode,
)
from waveformanalysis_tpu_torch.formats.directory import DirectoryLayout

logger = logging.getLogger(__name__)

EVENT_HEADER_BYTES = 16
CH_HEADER_BYTES = 12

V1725_WAVE_DTYPE = np.dtype(
    [
        ("board", "i2"),
        ("channel", "i2"),
        ("timestamp", "i8"),
        ("baseline", "f8"),
        ("trunc", "b1"),
        ("wave", "O"),
    ]
)


@dataclass
class V1725Wave:
    board: int
    channel: int
    timestamp: int
    trunc: bool
    baseline: int
    waveform: np.ndarray


V1725_SPEC = FormatSpec(
    name="v1725_bin",
    version="0.1",
    columns=ColumnMapping(),
    timestamp_unit=TimestampUnit.NANOSECONDS,
    raw_timestamp_mode=RawTimestampMode.SAMPLE_INDEX,
    file_pattern="*.bin",
    header_rows_first_file=0,
    header_rows_other_files=0,
    delimiter="",
    sampling_rate_hz=250e6,
    metadata={
        "manufacturer": "CAEN",
        "model": "V1725",
        "description": "CAEN V1725 DAW_DEMO binary",
    },
)

V1725_LAYOUT = DirectoryLayout(
    name="v1725",
    raw_subdir="RAW",
    run_path_template="{data_root}/{run_name}/{raw_subdir}",
    file_glob_pattern="*.bin",
    file_extension=".bin",
    # both legacy CH naming and DAW_DEMO bX/segX naming
    channel_regex=r"(?:CH|_b)(\d+)",
    file_index_regex=r"(?:_seg|_)(\d+)\.bin$",
    run_info_pattern="{run_name}_info.txt",
    metadata={"manufacturer": "CAEN", "model": "V1725"},
)


def _mask_channels(mask: int) -> List[int]:
    """Bit positions set in the channel mask, ascending."""
    out = []
    bit = 0
    while mask:
        if mask & 1:
            out.append(bit)
        bit += 1
        mask >>= 1
    return out


class V1725Reader(FormatReader):
    """Whole-buffer offset-walking binary reader."""

    def __init__(self, spec: Optional[FormatSpec] = None) -> None:
        super().__init__(spec or V1725_SPEC)

    @staticmethod
    def _extract_board_from_path(path: Path) -> int:
        m = re.search(r"_b(\d+)", path.name, flags=re.IGNORECASE)
        return int(m.group(1)) if m else 0

    def iter_waves(self, file_paths: List[PathLike]) -> Iterator[V1725Wave]:
        for file_path in file_paths:
            path = Path(file_path)
            if not path.exists():
                logger.warning("File not found: %s", path)
                continue
            board_id = self._extract_board_from_path(path)
            buf = path.read_bytes()
            view = memoryview(buf)
            n = len(buf)
            pos = 0
            while pos + EVENT_HEADER_BYTES <= n:
                header = view[pos : pos + EVENT_HEADER_BYTES]
                pos += EVENT_HEADER_BYTES
                channels = _mask_channels(header[4] | (header[11] << 8))
                truncated = False
                for ch in channels:
                    if pos + CH_HEADER_BYTES > n:
                        logger.warning("Short channel header in %s", path)
                        truncated = True
                        break
                    ch_header = view[pos : pos + CH_HEADER_BYTES]
                    pos += CH_HEADER_BYTES
                    ch_size_words = (
                        int.from_bytes(ch_header[0:3], "little") & ((1 << 22) - 1)
                    )
                    sig_bytes = (ch_size_words - 3) * 4
                    trunc = bool((ch_header[3] >> 6) & 1)
                    timestamp = int.from_bytes(ch_header[4:10], "little")
                    baseline = int.from_bytes(ch_header[10:12], "little")
                    if sig_bytes < 0 or pos + sig_bytes > n:
                        logger.warning("Short waveform in %s", path)
                        truncated = True
                        break
                    sig = np.frombuffer(buf, dtype="<i2", count=sig_bytes // 2,
                                        offset=pos)
                    pos += sig_bytes
                    yield V1725Wave(
                        board=board_id,
                        channel=ch,
                        timestamp=timestamp,
                        trunc=trunc,
                        baseline=baseline,
                        waveform=sig,
                    )
                if truncated:
                    break

    def read_file(self, file_path: PathLike, is_first_file: bool = True) -> np.ndarray:
        return self._waves_to_array(list(self.iter_waves([file_path])))

    def read_files(self, file_paths: List[PathLike], show_progress: bool = False,
                   **kwargs) -> np.ndarray:
        return self._waves_to_array(list(self.iter_waves(file_paths)))

    def read_files_generator(self, file_paths: List[PathLike], chunk_size: int = 10,
                             **kwargs) -> Iterator[np.ndarray]:
        for fp in file_paths:
            yield self.read_file(fp)

    def extract_columns(self, data: np.ndarray):
        if data.size == 0:
            return {
                "board": np.array([], dtype=int),
                "channel": np.array([], dtype=int),
                "timestamp": np.array([], dtype=np.int64),
                "samples": np.array([]).reshape(0, 0),
                "baseline": np.array([], dtype=float),
            }
        if data.dtype.names:
            return {
                "board": data["board"].astype(int, copy=False),
                "channel": data["channel"].astype(int, copy=False),
                "timestamp": data["timestamp"].astype(np.int64, copy=False),
                "samples": np.array(data["wave"], dtype=object),
                "baseline": data["baseline"].astype(float, copy=False),
            }
        return super().extract_columns(data)

    def validate_data(self, data: np.ndarray) -> bool:
        return True

    @staticmethod
    def _waves_to_array(waves: List[V1725Wave]) -> np.ndarray:
        if not waves:
            return np.array([]).reshape(0, 0)
        arr = np.empty(len(waves), dtype=V1725_WAVE_DTYPE)
        for i, w in enumerate(waves):
            arr[i] = (w.board, w.channel, w.timestamp, float(w.baseline),
                      w.trunc, w.waveform)
        return arr


class V1725Adapter(DAQAdapter):
    """Falls back to grouping all files under channel 0 when filenames carry
    no channel info (channels come from the binary payload instead)."""

    def scan_run(self, data_root: str, run_name: str):
        try:
            groups = super().scan_run(data_root, run_name)
        except FileNotFoundError:
            return {}
        if groups:
            return groups
        raw_path = self.get_raw_path(data_root, run_name)
        files = self.directory_layout.list_files(raw_path)
        if not files:
            return {}
        return {0: files}


V1725_ADAPTER = V1725Adapter(
    name="v1725",
    format_reader=V1725Reader(),
    directory_layout=V1725_LAYOUT,
)

register_adapter(V1725_ADAPTER)
