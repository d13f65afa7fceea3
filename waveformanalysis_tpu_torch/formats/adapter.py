"""DAQ adapters: reader + layout bundles, with a process-wide registry.

Behavioral analog of the reference adapter layer
(reference: waveform_analysis/utils/formats/adapter.py:44-399): an adapter
exposes ``scan_run`` (channel -> ordered file list), ``load_channel``,
column extraction with ps-normalized timestamps, and ``get_file_epoch``
(file ctime -> epoch ns). ``register_adapter`` / ``get_adapter`` /
``list_adapters`` manage the registry consulted by config inference.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from waveformanalysis_tpu_torch.formats.base import FormatReader, FormatSpec
from waveformanalysis_tpu_torch.formats.directory import DirectoryLayout

logger = logging.getLogger(__name__)


@dataclass
class DAQAdapter:
    """A complete DAQ data-access bundle."""

    name: str
    format_reader: FormatReader
    directory_layout: DirectoryLayout

    @property
    def format_spec(self) -> FormatSpec:
        return self.format_reader.spec

    @property
    def layout(self) -> DirectoryLayout:
        return self.directory_layout

    @property
    def sampling_rate_hz(self) -> Optional[float]:
        return self.format_spec.sampling_rate_hz

    # -- paths / scanning -----------------------------------------------------

    def get_raw_path(self, data_root: str, run_name: str) -> Path:
        return self.directory_layout.get_raw_path(data_root, run_name)

    def get_run_path(self, data_root: str, run_name: str) -> Path:
        return self.directory_layout.get_run_path(data_root, run_name)

    def scan_run(self, data_root: str, run_name: str) -> Dict[int, List[Path]]:
        """{channel: [ordered file paths]}; raises if the run dir is missing."""
        raw_path = self.get_raw_path(data_root, run_name)
        if not raw_path.exists():
            raise FileNotFoundError(f"Run directory does not exist: {raw_path}")
        groups = self.directory_layout.group_files_by_channel(raw_path)
        return {ch: [f["path"] for f in files] for ch, files in groups.items()}

    def scan_run_detailed(self, data_root: str, run_name: str) -> Dict[int, List[Dict]]:
        raw_path = self.get_raw_path(data_root, run_name)
        if not raw_path.exists():
            raise FileNotFoundError(f"Run directory does not exist: {raw_path}")
        return self.directory_layout.group_files_by_channel(raw_path)

    # -- loading ---------------------------------------------------------------

    def load_channel(
        self,
        data_root: str,
        run_name: str,
        channel: int,
        max_files: Optional[int] = None,
        show_progress: bool = False,
        **kwargs: Any,
    ) -> np.ndarray:
        files = self.scan_run(data_root, run_name).get(channel, [])
        if max_files is not None:
            files = files[:max_files]
        if not files:
            return np.array([]).reshape(0, 0)
        return self.format_reader.read_files(files, show_progress=show_progress, **kwargs)

    def load_all_channels(
        self,
        data_root: str,
        run_name: str,
        max_files: Optional[int] = None,
        **kwargs: Any,
    ) -> Dict[int, np.ndarray]:
        out = {}
        for ch in sorted(self.scan_run(data_root, run_name)):
            out[ch] = self.load_channel(data_root, run_name, ch, max_files=max_files, **kwargs)
        return out

    def load_channel_generator(
        self,
        data_root: str,
        run_name: str,
        channel: int,
        chunk_size: int = 10,
        **kwargs: Any,
    ) -> Iterator[np.ndarray]:
        files = self.scan_run(data_root, run_name).get(channel, [])
        yield from self.format_reader.read_files_generator(files, chunk_size=chunk_size, **kwargs)

    # -- column extraction ------------------------------------------------------

    def extract_columns(self, data: np.ndarray) -> Dict[str, np.ndarray]:
        return self.format_reader.extract_columns(data)

    def normalize_timestamp_to_ps(
        self, timestamps: np.ndarray, dt_ns: Optional[int] = None
    ) -> np.ndarray:
        return self.format_spec.normalize_timestamp_to_ps(timestamps, dt_ns=dt_ns)

    def extract_and_convert(self, data: np.ndarray) -> Dict[str, np.ndarray]:
        """Extract columns with timestamps normalized to ps."""
        cols = self.extract_columns(data)
        cols["timestamp"] = self.normalize_timestamp_to_ps(cols["timestamp"])
        return cols

    def extract_and_convert_ns(self, data: np.ndarray) -> Dict[str, np.ndarray]:
        cols = self.extract_columns(data)
        cols["timestamp"] = self.format_reader.convert_timestamp_to_ns(cols["timestamp"])
        return cols

    def validate_data(self, data: np.ndarray) -> bool:
        return self.format_reader.validate_data(data)

    def get_file_epoch(self, file_path: Path) -> int:
        """Epoch of a raw file as integer ns (file ctime; reference:
        adapter.py:312)."""
        st = Path(file_path).stat()
        return int(st.st_ctime * 1e9)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, DAQAdapter] = {}


def register_adapter(adapter: DAQAdapter) -> None:
    if adapter.name in _REGISTRY:
        logger.debug("Re-registering DAQ adapter %r", adapter.name)
    _REGISTRY[adapter.name] = adapter
    # adapter metadata feeds config inference; drop any stale snapshot
    from waveformanalysis_tpu_torch.config.adapter_info import clear_adapter_info_cache

    clear_adapter_info_cache()


def get_adapter(name: str) -> DAQAdapter:
    _ensure_builtins()
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown DAQ adapter {name!r}; registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def list_adapters() -> List[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


def is_adapter_registered(name: str) -> bool:
    _ensure_builtins()
    return name in _REGISTRY


def unregister_adapter(name: str) -> bool:
    return _REGISTRY.pop(name, None) is not None


_builtins_loaded = False


def _ensure_builtins() -> None:
    """Lazy-import builtin adapters so importing this module stays cheap."""
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    from waveformanalysis_tpu_torch.formats import v1725, vx2730  # noqa: F401
