"""EventAnalyzer: grouping and pairing façade.

Behavioral analog of the reference EventAnalyzer
(reference: waveform_analysis/core/processing/analyzer.py:40-160), delegating
to the vectorized grouping ops.

Port of ``waveformanalysis_tpu/processing/analyzer.py``; ``device`` is
where ``backend="device"`` runs (default CUDA).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from waveformanalysis_tpu_torch.ops.grouping import group_multi_channel_hits, pair_events


class EventAnalyzer:
    """Groups single-channel hits into events and pairs them across channels."""

    # start_channel_slice default 6 matches the reference constructor
    # (analyzer.py:27) — it only prefixes the area_ch*/height_ch* output
    # column names, it never slices data
    def __init__(self, n_channels: int = 2, start_channel_slice: int = 6) -> None:
        self.n_channels = n_channels
        self.start_channel_slice = start_channel_slice
        self.time_window_ns = 100

    def group_events(
        self,
        df: Any,
        time_window_ns: Optional[float] = None,
        use_numba: bool = True,
        n_processes: Optional[int] = None,
        backend: str = "auto",
        device: Any = None,
    ) -> Any:
        if time_window_ns is not None:
            self.time_window_ns = time_window_ns
        return group_multi_channel_hits(
            df, self.time_window_ns, use_numba=use_numba,
            n_processes=n_processes, backend=backend, device=device,
        )

    def pair_events(
        self, df_events: Any, time_window_ns: Optional[float] = None,
        backend: str = "auto", device: Any = None,
    ) -> Any:
        tw = time_window_ns if time_window_ns is not None else self.time_window_ns
        return pair_events(
            df_events, tw, n_channels=self.n_channels,
            start_channel=self.start_channel_slice, backend=backend,
            device=device,
        )

    def pair_events_with(
        self, df_events: Any, strategy: Callable[[Any, int], Any]
    ) -> Any:
        """Custom pairing strategy with derived-column backfill."""
        df_paired = strategy(df_events, self.n_channels).copy()
        if "timestamps" in df_paired.columns and "delta_t" not in df_paired.columns:
            df_paired["delta_t"] = df_paired["timestamps"].apply(
                lambda x: (x[-1] - x[0]) / 1000.0
            )
        for key, prefix in (("areas", "area"), ("heights", "height")):
            alt = {"areas": "charges", "heights": "peaks"}[key]
            col = key if key in df_paired.columns else (
                alt if alt in df_paired.columns else None
            )
            if col is None:
                continue
            for i in range(min(self.n_channels, 8)):
                df_paired[f"{prefix}_ch{self.start_channel_slice + i}"] = (
                    df_paired[col].apply(
                        lambda x, i=i: x[i] if len(x) > i else np.nan
                    )
                )
        return df_paired
