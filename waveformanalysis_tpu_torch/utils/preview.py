"""Quick waveform previews without the full pipeline.

Behavioral analog of the reference WaveformPreviewer
(reference: waveform_analysis/utils/preview.py:181-928): load a small event
range (by index or timestamp) straight from raw files, minimally structure
it, preview basic features, and render overlay/grid plots (matplotlib is
optional — data methods work headless).

Port of ``waveformanalysis_tpu/utils/preview.py``. The records a Context
hands to ``plot_records_waveforms`` are read on the host (``device.to_host``),
through ``RecordsView``'s host methods only.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np

from waveformanalysis_tpu_torch.device import to_host
from waveformanalysis_tpu_torch.dtypes.table import Table

logger = logging.getLogger(__name__)


class WaveformPreviewer:
    """Loads and inspects a handful of events cheaply."""

    def __init__(
        self,
        data_root: str,
        run_name: str,
        daq_adapter: str = "vx2730",
    ) -> None:
        from waveformanalysis_tpu_torch.formats.adapter import get_adapter

        self.data_root = str(data_root)
        self.run_name = run_name
        self.adapter = get_adapter(daq_adapter)

    # -- loading -----------------------------------------------------------------

    def load_events(
        self,
        channel: int = 0,
        start: int = 0,
        n_events: int = 16,
        max_files: Optional[int] = None,
    ) -> Table:
        """Events [start, start+n_events) of one channel, minimally structured."""
        files = self.adapter.scan_run(self.data_root, self.run_name).get(channel, [])
        if max_files:
            files = files[:max_files]
        collected: List[np.ndarray] = []
        rows = 0
        for i, f in enumerate(files):
            arr = self.adapter.format_reader.read_file(f, is_first_file=(i == 0))
            if arr.size == 0:
                continue
            collected.append(arr)
            rows += len(arr)
            if rows >= start + n_events:
                break
        if not collected:
            return Table({})
        raw = np.vstack(collected) if collected[0].ndim == 2 else np.concatenate(collected)
        raw = raw[start : start + n_events]
        return self._structure(raw, channel)

    def load_by_timestamp(
        self,
        channel: int,
        start_ps: int,
        end_ps: int,
        max_files: Optional[int] = None,
    ) -> Table:
        """Events whose (ps-normalized) timestamp lies in [start_ps, end_ps)."""
        files = self.adapter.scan_run(self.data_root, self.run_name).get(channel, [])
        if max_files:
            files = files[:max_files]
        keep: List[np.ndarray] = []
        for i, f in enumerate(files):
            arr = self.adapter.format_reader.read_file(f, is_first_file=(i == 0))
            if arr.size == 0:
                continue
            cols = self.adapter.extract_and_convert(arr)
            ts = cols["timestamp"]
            mask = (ts >= start_ps) & (ts < end_ps)
            if np.any(mask):
                keep.append(arr[mask] if arr.ndim == 2 else arr[mask])
            if len(ts) and ts.max() >= end_ps:
                break
        if not keep:
            return Table({})
        raw = np.vstack(keep) if keep[0].ndim == 2 else np.concatenate(keep)
        return self._structure(raw, channel)

    def _structure(self, raw: np.ndarray, channel: int) -> Table:
        cols = self.adapter.extract_and_convert(raw)
        samples = cols["samples"]
        if samples.dtype == object:  # variable-length (binary formats)
            max_len = max((len(w) for w in samples), default=0)
            waves = np.zeros((len(samples), max_len), dtype=np.float32)
            lengths = np.zeros(len(samples), dtype=np.int32)
            for i, w in enumerate(samples):
                waves[i, : len(w)] = w
                lengths[i] = len(w)
        else:
            waves = samples.astype(np.float32)
            lengths = np.full(len(samples), waves.shape[1], np.int32)
        return Table({
            "board": cols["board"].astype(np.int16),
            "channel": cols["channel"].astype(np.int16),
            "timestamp": cols["timestamp"].astype(np.int64),
            "baseline": cols["baseline"].astype(np.float64),
            "event_length": lengths,
            "wave": waves,
        })

    # -- features ------------------------------------------------------------------

    def preview_features(self, table: Table) -> Dict[str, np.ndarray]:
        """Quick height/area estimates for previewed events."""
        if len(table) == 0:
            return {"height": np.zeros(0), "area": np.zeros(0)}
        waves = np.asarray(table["wave"], dtype=np.float64)
        baseline = np.asarray(table["baseline"], dtype=np.float64)
        signal = baseline[:, None] - waves
        return {
            "height": signal.max(axis=1),
            "area": signal.sum(axis=1),
            "amp": waves.max(axis=1) - waves.min(axis=1),
        }

    def summary(self, table: Table) -> str:
        feats = self.preview_features(table)
        n = len(table)
        if n == 0:
            return "(no events)"
        return (
            f"{n} events | baseline ~{np.mean(np.asarray(table['baseline'])):.1f} "
            f"| height {feats['height'].mean():.1f}±{feats['height'].std():.1f} "
            f"| area {feats['area'].mean():.1f}"
        )

    # -- plotting ---------------------------------------------------------------------

    @staticmethod
    def _resolve_dt(dt: Optional[float],
                    sampling_interval_ns: Optional[float]) -> Optional[float]:
        """`dt` (ns/sample) scales the x-axis; `sampling_interval_ns` is the
        deprecated alias (reference: tests/test_preview_dt_alias.py)."""
        if sampling_interval_ns is not None:
            import warnings

            warnings.warn(
                "sampling_interval_ns is deprecated; pass dt= instead",
                DeprecationWarning, stacklevel=3)
            if dt is None:
                dt = sampling_interval_ns
        return dt

    def plot_overlay(self, table: Table, max_events: int = 32,
                     annotate: bool = False, ax: Any = None,
                     dt: Optional[float] = None,
                     sampling_interval_ns: Optional[float] = None,
                     **kwargs: Any) -> Any:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        dt = self._resolve_dt(dt, sampling_interval_ns)
        if ax is None:
            _fig, ax = plt.subplots(figsize=(10, 5))
        waves = np.asarray(table["wave"])[:max_events]
        t_axis = (np.arange(waves.shape[1]) * dt
                  if dt is not None and len(waves) else None)
        for w in waves:
            if t_axis is not None:
                ax.plot(t_axis, w, alpha=0.4, lw=0.8, **kwargs)
            else:
                ax.plot(w, alpha=0.4, lw=0.8, **kwargs)
        title = f"{self.run_name}: {len(waves)} waveforms"
        if annotate and len(waves):
            feats = self.preview_features(table)
            title += (f" | height {feats['height'][:max_events].mean():.1f}"
                      f" | area {feats['area'][:max_events].mean():.1f}")
            baseline = np.asarray(table["baseline"])[:max_events]
            peak_idx = np.argmax(baseline[:, None] - waves, axis=1)
            peak_x = peak_idx * dt if dt is not None else peak_idx
            ax.plot(peak_x, waves[np.arange(len(waves)), peak_idx],
                    "v", ms=4, color="crimson", alpha=0.7, lw=0)
        ax.set_xlabel("time (ns)" if dt is not None else "sample")
        ax.set_ylabel("ADC")
        ax.set_title(title)
        return ax

    def plot_grid(self, table: Table, n_cols: int = 4, max_events: int = 16,
                  annotate: bool = False, dt: Optional[float] = None,
                  sampling_interval_ns: Optional[float] = None) -> Any:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        dt = self._resolve_dt(dt, sampling_interval_ns)
        waves = np.asarray(table["wave"])[:max_events]
        feats = self.preview_features(table) if annotate and len(waves) \
            else None
        t_axis = (np.arange(waves.shape[1]) * dt
                  if dt is not None and len(waves) else None)
        n = len(waves)
        n_rows = (n + n_cols - 1) // n_cols
        fig, axes = plt.subplots(n_rows, n_cols,
                                 figsize=(3 * n_cols, 2 * n_rows),
                                 squeeze=False)
        for i in range(n_rows * n_cols):
            ax = axes[i // n_cols][i % n_cols]
            if i < n:
                if t_axis is not None:
                    ax.plot(t_axis, waves[i], lw=0.8)
                else:
                    ax.plot(waves[i], lw=0.8)
                label = f"evt {i}"
                if feats is not None:
                    label += (f" h={feats['height'][i]:.0f}"
                              f" a={feats['area'][i]:.0f}")
                ax.set_title(label, fontsize=8)
            else:
                ax.axis("off")
        fig.tight_layout()
        return fig


def preview_waveforms(
    run_name: str,
    channel: int,
    event_range: Optional[tuple] = None,
    timestamp_range: Optional[tuple] = None,
    plot_mode: str = "overlay",
    annotate: bool = True,
    save_path: Optional[str] = None,
    data_root: str = "DAQ",
    daq_adapter: str = "vx2730",
    **kwargs: Any,
) -> Any:
    """One-stop preview: load a slice of one channel and plot it
    (reference: utils/preview.py:830 preview_waveforms). Exactly one of
    event_range / timestamp_range selects events; plot_mode is
    'overlay' or 'grid'; returns the Figure (saved when save_path given).
    """
    if (event_range is None) == (timestamp_range is None):
        raise ValueError(
            "specify exactly one of event_range or timestamp_range")
    previewer = WaveformPreviewer(data_root=data_root, run_name=run_name,
                                  daq_adapter=daq_adapter)
    if event_range is not None:
        start, end = event_range
        table = previewer.load_events(channel, start=start,
                                      n_events=end - start)
    else:
        start_ps, end_ps = timestamp_range
        table = previewer.load_by_timestamp(channel, start_ps, end_ps)
    if plot_mode == "overlay":
        ax = previewer.plot_overlay(table, annotate=annotate, **kwargs)
        fig = ax.figure
    elif plot_mode == "grid":
        fig = previewer.plot_grid(table, annotate=annotate, **kwargs)
    else:
        raise ValueError(
            f"invalid plot_mode {plot_mode!r}: use 'overlay' or 'grid'")
    if save_path is not None:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        logger.info("preview figure saved to %s", save_path)
    return fig


def _resolve_records_view(source: Any, run_id: Optional[str] = None) -> Any:
    """RecordsView passes through; a Context-like source loads records +
    wave_pool for run_id (reference: utils/preview.py:970)."""
    from waveformanalysis_tpu_torch.data.records_view import RecordsView

    if isinstance(source, RecordsView):
        return source
    if hasattr(source, "get_data"):
        if run_id is None:
            raise ValueError("run_id is required when source is a Context")
        records = to_host(source.get_data(run_id, "records"))
        wave_pool = to_host(source.get_data(run_id, "wave_pool"))
        return RecordsView(records, wave_pool)
    raise TypeError(
        f"source must be a RecordsView or Context-like, got {type(source).__name__}"
    )


def plot_records_waveforms(
    source: Any,
    run_id: Optional[str] = None,
    record_ids: Any = None,
    board: Optional[int] = None,
    channel: Optional[int] = None,
    timestamp_range: Optional[tuple] = None,
    height_range: Optional[tuple] = None,
    area_range: Optional[tuple] = None,
    sample_start: int = 0,
    sample_end: Optional[int] = None,
    limit: Optional[int] = 9,
    ncols: int = 2,
    figsize_per_plot: tuple = (6, 4),
    dt: Optional[float] = None,
    title: Optional[str] = None,
    show_baseline: bool = True,
    show_peak: bool = True,
    save_path: Optional[str] = None,
) -> Any:
    """Select records by id or by filters and plot their waveforms.

    Behavioral analog of the reference plot_records_waveforms
    (reference: utils/preview.py:912-1060): source is a RecordsView or a
    Context (then run_id is required); records filter by explicit ids
    (preserving the given order) or by board/channel/timestamp_range plus
    height/area ranges computed on the [sample_start, sample_end) window;
    each selected record renders in its own subplot with optional baseline
    line and peak marker; dt defaults to records.dt. Returns the Figure.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    rv = _resolve_records_view(source, run_id=run_id)
    records = rv.records
    rid_col = np.asarray(records["record_id"], dtype=np.int64)

    if record_ids is not None:
        if np.isscalar(record_ids):
            selected = [int(record_ids)]
        else:
            selected = [int(r) for r in record_ids]
        known = set(rid_col.tolist())
        missing = [r for r in selected if r not in known]
        if missing:
            raise KeyError(f"record_ids not found: {missing}")
    else:
        mask = np.ones(len(records), dtype=bool)
        if board is not None and "board" in records:
            mask &= np.asarray(records["board"]) == board
        if channel is not None and "channel" in records:
            mask &= np.asarray(records["channel"]) == channel
        if timestamp_range is not None:
            ts = np.asarray(records["timestamp"], dtype=np.int64)
            mask &= (ts >= timestamp_range[0]) & (ts <= timestamp_range[1])
        selected = [int(r) for r in rid_col[mask]]

    window = (sample_start, sample_end) if (
        sample_start or sample_end is not None) else None
    metrics = {}
    kept = []
    for r in selected:
        sig = rv.signals(r, window=window)
        if sig.size == 0:
            continue
        height = float(sig.max())
        area = float(sig.sum())
        if height_range is not None and not (
                height_range[0] <= height <= height_range[1]):
            continue
        if area_range is not None and not (
                area_range[0] <= area <= area_range[1]):
            continue
        metrics[r] = {"height": height, "area": area,
                      "peak_idx": int(np.argmax(sig))}
        kept.append(r)
    if limit is not None:
        kept = kept[:limit]

    n = len(kept)
    if n == 0:
        fig, ax = plt.subplots(figsize=figsize_per_plot)
        ax.text(0.5, 0.5, "no records matched", ha="center", va="center")
        ax.axis("off")
    else:
        nrows = (n + ncols - 1) // ncols
        fig, axes = plt.subplots(
            nrows, ncols,
            figsize=(figsize_per_plot[0] * ncols, figsize_per_plot[1] * nrows),
            squeeze=False,
        )
        dt_col = (np.asarray(records["dt"], dtype=np.float64)
                  if "dt" in records else None)
        for i in range(nrows * ncols):
            ax = axes[i // ncols][i % ncols]
            if i >= n:
                ax.axis("off")
                continue
            r = kept[i]
            wave = rv.waves(r, window=window).astype(np.float64)
            row = rv._row(r)
            step = dt if dt is not None else (
                float(dt_col[row]) if dt_col is not None and dt_col[row] > 0
                else 1.0)
            t = (sample_start + np.arange(len(wave))) * step
            ax.plot(t, wave, lw=0.9)
            if show_baseline:
                ax.axhline(rv.baseline(r), ls="--", lw=0.8, alpha=0.7,
                           label=f"baseline {rv.baseline(r):.1f}")
            if show_peak:
                pk = metrics[r]["peak_idx"]
                ax.plot(t[pk], wave[pk], "v", ms=6,
                        label=f"peak h={metrics[r]['height']:.1f}")
            ax.set_title(
                f"record {r} (h={metrics[r]['height']:.1f}, "
                f"a={metrics[r]['area']:.1f})", fontsize=9)
            ax.set_xlabel("time" if (dt is not None or dt_col is not None)
                          else "sample")
            ax.set_ylabel("ADC")
            if show_baseline or show_peak:
                ax.legend(fontsize=7, loc="best")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    return fig
