"""DAQ run inspection: per-channel file stats and acquisition windows.

Behavioral analog of the reference DAQ utilities
(reference: waveform_analysis/utils/daq/daq_run.py:49 and
daq_analyzer.py:43): scan a run directory, summarize per-channel file
counts/sizes, estimate acquisition windows from first/last timetags, render
overview tables, and export JSON.

Port of ``waveformanalysis_tpu/utils/daq.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class ChannelStats:
    channel: int
    n_files: int = 0
    total_bytes: int = 0
    first_timetag_ps: Optional[int] = None
    last_timetag_ps: Optional[int] = None
    n_events_sampled: int = 0

    @property
    def acquisition_window_s(self) -> Optional[float]:
        if self.first_timetag_ps is None or self.last_timetag_ps is None:
            return None
        return (self.last_timetag_ps - self.first_timetag_ps) / 1e12

    def to_dict(self) -> Dict[str, Any]:
        return {
            "channel": self.channel,
            "n_files": self.n_files,
            "total_bytes": self.total_bytes,
            "first_timetag_ps": self.first_timetag_ps,
            "last_timetag_ps": self.last_timetag_ps,
            "acquisition_window_s": self.acquisition_window_s,
            "n_events_sampled": self.n_events_sampled,
        }


class DAQRun:
    """A scanned DAQ run directory with per-channel stats."""

    def __init__(
        self,
        data_root: str,
        run_name: str,
        adapter: Any = None,
        adapter_name: str = "vx2730",
    ) -> None:
        if adapter is None:
            from waveformanalysis_tpu_torch.formats.adapter import get_adapter

            adapter = get_adapter(adapter_name)
        self.adapter = adapter
        self.data_root = str(data_root)
        self.run_name = run_name
        self._groups: Optional[Dict[int, List[Dict[str, Any]]]] = None
        self._stats: Optional[Dict[int, ChannelStats]] = None

    # -- scanning -------------------------------------------------------------

    def scan(self, force: bool = False) -> Dict[int, List[Dict[str, Any]]]:
        if self._groups is None or force:
            try:
                self._groups = self.adapter.scan_run_detailed(
                    self.data_root, self.run_name
                )
            except FileNotFoundError:
                self._groups = {}
        return self._groups

    @property
    def channels(self) -> List[int]:
        return sorted(self.scan())

    def get_channel_files(self) -> Dict[int, List[str]]:
        return {ch: [str(f["path"]) for f in files]
                for ch, files in self.scan().items()}

    @property
    def run_path(self) -> Path:
        return self.adapter.get_run_path(self.data_root, self.run_name)

    # -- stats ----------------------------------------------------------------

    def channel_stats(self, sample_events: int = 64, force: bool = False
                      ) -> Dict[int, ChannelStats]:
        """Per-channel stats; first/last timetags come from parsing the first
        and last file of each channel (bounded work)."""
        if self._stats is not None and not force:
            return self._stats
        stats: Dict[int, ChannelStats] = {}
        for ch, files in self.scan().items():
            st = ChannelStats(
                channel=ch,
                n_files=len(files),
                total_bytes=sum(f.get("size", 0) for f in files),
            )
            paths = [f["path"] for f in files]
            if paths:
                try:
                    first = self.adapter.format_reader.read_file(
                        paths[0], is_first_file=True
                    )
                    last = first if len(paths) == 1 else (
                        self.adapter.format_reader.read_file(
                            paths[-1], is_first_file=False
                        )
                    )
                    ts_first = self._timetags(first)
                    ts_last = self._timetags(last)
                    if len(ts_first):
                        st.first_timetag_ps = int(ts_first.min())
                        st.n_events_sampled += len(ts_first)
                    if len(ts_last):
                        st.last_timetag_ps = int(ts_last.max())
                except Exception:
                    pass
            stats[ch] = st
        self._stats = stats
        return stats

    def _timetags(self, raw: np.ndarray) -> np.ndarray:
        if raw.size == 0:
            return np.zeros(0, dtype=np.int64)
        cols = self.adapter.extract_columns(raw)
        return self.adapter.normalize_timestamp_to_ps(cols["timestamp"])

    # -- acquisition-window analysis -------------------------------------------

    def compute_acquisition_times(
        self, force_reparse: bool = False
    ) -> Dict[int, Dict[str, Any]]:
        """Per-channel acquisition analysis: first/last timetag, duration,
        sampled event rate (reference: daq_run.py:321)."""
        out: Dict[int, Dict[str, Any]] = {}
        for ch, st in self.channel_stats(force=force_reparse).items():
            duration = st.acquisition_window_s
            rate = (
                st.n_events_sampled / duration
                if duration and st.n_events_sampled else None
            )
            out[ch] = {
                "first_timetag_ps": st.first_timetag_ps,
                "last_timetag_ps": st.last_timetag_ps,
                "duration_s": duration,
                "n_events_sampled": st.n_events_sampled,
                "sampled_event_rate_hz": rate,
                "n_files": st.n_files,
                "total_bytes": st.total_bytes,
            }
        return out

    def get_run_acquisition_window(
        self,
    ) -> tuple[Optional[int], Optional[int]]:
        """(earliest first-timetag, latest last-timetag) across channels in
        ps (reference: daq_run.py:413)."""
        stats = self.channel_stats()
        firsts = [s.first_timetag_ps for s in stats.values()
                  if s.first_timetag_ps is not None]
        lasts = [s.last_timetag_ps for s in stats.values()
                 if s.last_timetag_ps is not None]
        return (min(firsts) if firsts else None,
                max(lasts) if lasts else None)

    def get_channel_file_details(
        self, channel: int
    ) -> Optional[List[Dict[str, Any]]]:
        """Per-file name/path/size/index rows for one channel
        (reference: daq_run.py:424)."""
        groups = self.scan()
        if channel not in groups:
            return None
        out = []
        for i, f in enumerate(groups[channel]):
            p = Path(str(f["path"]))
            out.append({
                "index": f.get("index", i),
                "name": p.name,
                "path": str(p),
                "size": int(f.get("size", 0)),
            })
        return out

    # -- reporting ------------------------------------------------------------

    def overview(self) -> str:
        stats = self.channel_stats()
        lines = [
            f"DAQ run: {self.run_name}",
            f"  path: {self.run_path}",
            f"  adapter: {self.adapter.name}",
            f"  channels: {len(stats)}",
            "",
            f"  {'ch':>4} {'files':>6} {'size(MB)':>10} {'window(s)':>10}",
        ]
        for ch in sorted(stats):
            st = stats[ch]
            window = st.acquisition_window_s
            lines.append(
                f"  {ch:>4} {st.n_files:>6} {st.total_bytes / 1e6:>10.2f} "
                f"{window if window is not None else float('nan'):>10.3f}"
            )
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "run_name": self.run_name,
            "data_root": self.data_root,
            "adapter": self.adapter.name,
            "run_path": str(self.run_path),
            "channels": {
                str(ch): st.to_dict() for ch, st in self.channel_stats().items()
            },
        }

    def export_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)


def format_size(bytes_val: int) -> str:
    """Human size (reference: daq_analyzer.py:83)."""
    val = float(bytes_val)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if val < 1024.0 or unit == "TB":
            return f"{val:.1f} {unit}" if unit != "B" else f"{int(val)} B"
        val /= 1024.0
    return f"{val:.1f} TB"


def format_time_ps(ps_val: Optional[int]) -> str:
    """Human time from a ps timetag (reference: daq_run.py:74)."""
    if ps_val is None:
        return "-"
    s = ps_val / 1e12
    if s < 1e-6:
        return f"{ps_val / 1e3:.1f} ns"
    if s < 1e-3:
        return f"{ps_val / 1e6:.1f} us"
    if s < 1.0:
        return f"{ps_val / 1e9:.1f} ms"
    if s < 120:
        return f"{s:.3f} s"
    return f"{s / 60:.2f} min"


_ANSI = {"green": "\x1b[32m", "yellow": "\x1b[33m", "red": "\x1b[31m",
         "cyan": "\x1b[36m", "bold": "\x1b[1m", "reset": "\x1b[0m"}


def _ansi(text: str, color: str, enable: bool) -> str:
    if not enable or color not in _ANSI:
        return text
    return f"{_ANSI[color]}{text}{_ANSI['reset']}"


def _size_color(size_bytes: int) -> str:
    if size_bytes >= 1 << 30:
        return "red"
    if size_bytes >= 100 << 20:
        return "yellow"
    return "green"


class DAQAnalyzer:
    """Multi-run comparisons over a data root
    (reference analog: utils/daq/daq_analyzer.py:43)."""

    def __init__(self, data_root: str, adapter_name: str = "vx2730") -> None:
        self.data_root = str(data_root)
        self.adapter_name = adapter_name
        self._runs: Dict[str, DAQRun] = {}

    # -- scanning -------------------------------------------------------------

    def scan_all_runs(self) -> "DAQAnalyzer":
        """Scan every run under the data root (chainable;
        reference: daq_analyzer.py:150)."""
        for name in self.list_runs():
            run = self.get_run(name)
            run.scan()
            self._runs[name] = run
        return self

    def get_all_runs(self) -> List[DAQRun]:
        if not self._runs:
            self.scan_all_runs()
        return [self._runs[k] for k in sorted(self._runs)]

    # -- display --------------------------------------------------------------

    def display_overview(self, color: bool = True, html: bool = False) -> str:
        """Colored multi-run overview table: per run, channel count, file
        count, total size, acquisition window
        (reference: daq_analyzer.py:276 display_overview — ANSI in
        terminals, HTML table for notebooks)."""
        rows = []
        for run in self.get_all_runs():
            stats = run.channel_stats()
            total = sum(s.total_bytes for s in stats.values())
            n_files = sum(s.n_files for s in stats.values())
            windows = [s.acquisition_window_s for s in stats.values()
                       if s.acquisition_window_s is not None]
            window = max(windows) if windows else None
            rows.append((run.run_name, len(stats), n_files, total, window))

        if html:
            parts = ["<table><thead><tr>"]
            for h in ("run", "channels", "files", "size", "window (s)"):
                parts.append(f"<th>{h}</th>")
            parts.append("</tr></thead><tbody>")
            for name, n_ch, n_files, total, window in rows:
                wtxt = f"{window:.3f}" if window is not None else "-"
                parts.append(
                    f"<tr><td>{name}</td><td>{n_ch}</td><td>{n_files}</td>"
                    f"<td style='color:{_size_color(total)}'>"
                    f"{format_size(total)}</td><td>{wtxt}</td></tr>"
                )
            parts.append("</tbody></table>")
            return "".join(parts)

        header = (f"{'run':<24} {'ch':>4} {'files':>6} {'size':>10} "
                  f"{'window(s)':>10}")
        lines = [
            _ansi(f"Data root: {self.data_root}", "bold", color),
            _ansi(header, "cyan", color),
        ]
        for name, n_ch, n_files, total, window in rows:
            wtxt = f"{window:>10.3f}" if window is not None else f"{'-':>10}"
            lines.append(
                f"{name:<24} {n_ch:>4} {n_files:>6} "
                f"{_ansi(f'{format_size(total):>10}', _size_color(total), color)} "
                f"{wtxt}"
            )
        return "\n".join(lines)

    def display_run_channel_details(
        self, run_name: str, show_files: bool = False, color: bool = True,
    ) -> "DAQAnalyzer":
        """Print per-channel detail for one run; chainable
        (reference: daq_analyzer.py:427)."""
        run = self._runs.get(run_name) or self.get_run(run_name)
        stats = run.channel_stats()
        print(_ansi(f"Run {run_name} ({len(stats)} channels)", "bold", color))
        print(f"{'ch':>4} {'files':>6} {'size':>10} {'first tag':>14} "
              f"{'last tag':>14} {'window':>10}")
        for ch in sorted(stats):
            st = stats[ch]
            print(
                f"{ch:>4} {st.n_files:>6} "
                f"{_ansi(f'{format_size(st.total_bytes):>10}', _size_color(st.total_bytes), color)} "
                f"{format_time_ps(st.first_timetag_ps):>14} "
                f"{format_time_ps(st.last_timetag_ps):>14} "
                f"{st.acquisition_window_s if st.acquisition_window_s is not None else float('nan'):>10.3f}"
            )
            if show_files:
                for info in run.get_channel_file_details(ch) or []:
                    print(f"       {info['name']:<40} "
                          f"{format_size(info['size']):>10}")
        return self

    def save_to_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)

    def list_runs(self) -> List[str]:
        root = Path(self.data_root)
        if not root.exists():
            return []
        from waveformanalysis_tpu_torch.formats.adapter import get_adapter

        adapter = get_adapter(self.adapter_name)
        runs = []
        for child in sorted(root.iterdir()):
            if not child.is_dir() or child.name.startswith("_"):
                continue
            raw = adapter.get_raw_path(self.data_root, child.name)
            if raw.exists():
                runs.append(child.name)
        return runs

    def get_run(self, run_name: str) -> DAQRun:
        return DAQRun(self.data_root, run_name, adapter_name=self.adapter_name)

    def summary(self) -> str:
        runs = self.list_runs()
        lines = [f"Data root: {self.data_root} ({len(runs)} runs)"]
        for run_name in runs:
            run = self.get_run(run_name)
            stats = run.channel_stats()
            total_mb = sum(s.total_bytes for s in stats.values()) / 1e6
            lines.append(
                f"  {run_name}: {len(stats)} channels, {total_mb:.2f} MB"
            )
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "data_root": self.data_root,
            "runs": {name: self.get_run(name).to_dict()
                     for name in self.list_runs()},
        }
