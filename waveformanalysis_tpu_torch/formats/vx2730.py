"""CAEN VX2730 CSV adapter (500 MHz, ps timestamps, ';'-separated).

Behavioral analog of the reference VX2730 adapter
(reference: waveform_analysis/utils/formats/vx2730.py:77-134): column layout
board=0, channel=1, timestamp=2, samples from column 7, baseline window
columns 7-47; two header rows on the first file of a channel; engine fallback
pyarrow -> pandas-C -> numpy.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Optional

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

# pyarrow's CSV reader is internally multithreaded but NOT safe to enter from
# multiple python threads at once (observed segfaults when the channel-level
# thread pool parses files concurrently) — serialize entry; parallelism comes
# from pyarrow's own worker pool.
_PYARROW_LOCK = threading.Lock()

logger = logging.getLogger(__name__)

VX2730_SPEC = FormatSpec(
    name="vx2730_csv",
    version="1.0",
    columns=ColumnMapping(
        board=0, channel=1, timestamp=2,
        samples_start=7, samples_end=None,
        baseline_start=7, baseline_end=47,
    ),
    timestamp_unit=TimestampUnit.PICOSECONDS,
    raw_timestamp_mode=RawTimestampMode.UNIT,
    file_pattern="*CH*.CSV",
    header_rows_first_file=2,
    header_rows_other_files=0,
    delimiter=";",
    sampling_rate_hz=500e6,
    metadata={
        "manufacturer": "CAEN",
        "model": "VX2730",
        "description": "VX2730 CSV export (Compass)",
    },
)

VX2730_LAYOUT = DirectoryLayout(
    name="vx2730",
    raw_subdir="RAW",
    run_path_template="{data_root}/{run_name}/{raw_subdir}",
    file_glob_pattern="*CH*.CSV",
    file_extension=".CSV",
    channel_regex=r"CH(\d+)",
    file_index_regex=r"_(\d+)\.CSV$",
    run_info_pattern="{run_name}_info.txt",
    metadata={"manufacturer": "CAEN", "model": "VX2730"},
)


class VX2730Reader(FormatReader):
    """Delimited-text reader: native C++ -> pyarrow -> pandas -> numpy.

    The native engine (waveformanalysis_tpu_torch/native/csv_decode.cpp) parses
    the bytes in one pass straight into the float64 matrix (the reference
    uses Polars/PyArrow, vx2730.py:50-68). ``auto`` falls back to pyarrow,
    then pandas, when the g++ toolchain is unavailable; ``native`` raises.
    """

    def __init__(self, spec: Optional[FormatSpec] = None,
                 parse_engine: str = "auto") -> None:
        super().__init__(spec or VX2730_SPEC)
        self.parse_engine = parse_engine

    def read_file(self, file_path: PathLike, is_first_file: bool = True,
                  parse_engine: Optional[str] = None) -> np.ndarray:
        path = Path(file_path)
        if not path.exists() or path.stat().st_size == 0:
            return np.array([]).reshape(0, 0)
        skiprows = (
            self.spec.header_rows_first_file
            if is_first_file
            else self.spec.header_rows_other_files
        )
        engine = parse_engine or self.parse_engine
        if engine in ("auto", "native"):
            arr = self._read_native(path, skiprows)
            if arr is not None:
                return arr
            if engine == "native":
                raise RuntimeError("native CSV parse unavailable")
        if engine in ("auto", "pyarrow"):
            arr = self._read_pyarrow(path, skiprows)
            if arr is not None:
                return arr
            if engine == "pyarrow":
                raise RuntimeError("pyarrow CSV parse failed")
        if engine in ("auto", "pandas"):
            arr = self._read_pandas(path, skiprows)
            if arr is not None:
                return arr
            if engine == "pandas":
                raise RuntimeError("pandas CSV parse failed")
        return self._read_numpy(path, skiprows)

    def _read_native(self, path: Path, skiprows: int) -> Optional[np.ndarray]:
        try:
            from waveformanalysis_tpu_torch.native import decode_csv_bytes

            return decode_csv_bytes(
                path.read_bytes(), skip_rows=skiprows,
                delimiter=self.spec.delimiter,
            )
        except Exception as e:
            logger.debug("native parse of %s failed: %s", path, e)
            return None

    def _read_pyarrow(self, path: Path, skiprows: int) -> Optional[np.ndarray]:
        try:
            from pyarrow import csv as pacsv

            with _PYARROW_LOCK:
                table = pacsv.read_csv(
                    str(path),
                    read_options=pacsv.ReadOptions(
                        skip_rows=skiprows, autogenerate_column_names=True
                    ),
                    parse_options=pacsv.ParseOptions(
                        delimiter=self.spec.delimiter
                    ),
                    convert_options=pacsv.ConvertOptions(),
                )
            cols = [c.to_numpy(zero_copy_only=False) for c in table.columns]
            return np.column_stack([c.astype(np.float64) for c in cols])
        except Exception as e:
            logger.debug("pyarrow parse of %s failed: %s", path, e)
            return None

    def _read_pandas(self, path: Path, skiprows: int) -> Optional[np.ndarray]:
        try:
            import pandas as pd

            df = pd.read_csv(
                path, sep=self.spec.delimiter, header=None,
                skiprows=skiprows, engine="c", dtype=np.float64,
            )
            return df.to_numpy()
        except Exception as e:
            logger.debug("pandas parse of %s failed: %s", path, e)
            return None

    def _read_numpy(self, path: Path, skiprows: int) -> np.ndarray:
        try:
            arr = np.loadtxt(
                path, delimiter=self.spec.delimiter, skiprows=skiprows,
                dtype=np.float64, ndmin=2,
            )
            return arr
        except Exception as e:
            logger.warning("numpy parse of %s failed: %s", path, e)
            return np.array([]).reshape(0, 0)


VX2730_ADAPTER = DAQAdapter(
    name="vx2730",
    format_reader=VX2730Reader(),
    directory_layout=VX2730_LAYOUT,
)

register_adapter(VX2730_ADAPTER)
