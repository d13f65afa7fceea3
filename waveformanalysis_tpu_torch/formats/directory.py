"""DAQ run directory layouts.

Behavioral analog of the reference DirectoryLayout
(reference: waveform_analysis/utils/formats/directory.py:32-231): a run lives
at ``{data_root}/{run_name}/{raw_subdir}``; files are matched by glob,
channels extracted via regex (``CH(\\d+)``), and per-channel file lists are
ordered by a file-index regex.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class DirectoryLayout:
    """Describes where a DAQ run's raw files live and how to group them."""

    name: str
    raw_subdir: str = "RAW"
    run_path_template: str = "{data_root}/{run_name}/{raw_subdir}"
    file_glob_pattern: str = "*CH*.CSV"
    file_extension: str = ".CSV"
    channel_regex: str = r"CH(\d+)"
    file_index_regex: str = r"_(\d+)\.CSV$"
    run_info_pattern: Optional[str] = "{run_name}_info.txt"
    metadata: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._channel_re = re.compile(self.channel_regex)
        self._file_index_re = re.compile(self.file_index_regex, re.IGNORECASE)

    def get_raw_path(self, data_root: str, run_name: str) -> Path:
        path_str = self.run_path_template.format(
            data_root=data_root, run_name=run_name, raw_subdir=self.raw_subdir
        )
        path_str = re.sub(r"/+", "/", path_str).rstrip("/")
        return Path(path_str)

    def get_run_path(self, data_root: str, run_name: str) -> Path:
        raw = self.get_raw_path(data_root, run_name)
        if self.raw_subdir:
            return raw.parent
        return raw

    def get_run_info_path(self, data_root: str, run_name: str) -> Optional[Path]:
        if not self.run_info_pattern:
            return None
        name = self.run_info_pattern.format(run_name=run_name)
        return self.get_run_path(data_root, run_name) / name

    def extract_channel(self, filename: str) -> Optional[int]:
        m = self._channel_re.search(Path(filename).name)
        return int(m.group(1)) if m else None

    def extract_file_index(self, filename: str) -> int:
        m = self._file_index_re.search(Path(filename).name)
        return int(m.group(1)) if m else 0

    def list_files(self, raw_path: Path) -> List[Path]:
        if not raw_path.exists():
            return []
        files = sorted(raw_path.glob(self.file_glob_pattern))
        # case-insensitive extension fallback
        if not files and self.file_extension:
            alt = self.file_glob_pattern
            for pattern in {alt.lower(), alt.upper()}:
                files = sorted(raw_path.glob(pattern))
                if files:
                    break
        return files

    def group_files_by_channel(self, raw_path: Path) -> Dict[int, List[Dict[str, Any]]]:
        """{channel: [{path, index, name}, ...]} ordered by file index."""
        groups: Dict[int, List[Dict[str, Any]]] = {}
        for path in self.list_files(raw_path):
            ch = self.extract_channel(path.name)
            if ch is None:
                continue
            groups.setdefault(ch, []).append(
                {
                    "path": path,
                    "index": self.extract_file_index(path.name),
                    "name": path.name,
                    "size": path.stat().st_size if path.exists() else 0,
                }
            )
        for ch in groups:
            groups[ch].sort(key=lambda f: (f["index"], f["name"]))
        return groups
