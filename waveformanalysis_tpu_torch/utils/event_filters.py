"""Filters over grouped-event DataFrames.

Behavioral analog of the reference event filters
(reference: waveform_analysis/utils/event_filters.py:29-199): coincidence and
channel-membership filters over df_events-style tables. The reference uses
numba JIT loops; these are vectorized NumPy over the per-event arrays.

Port of ``waveformanalysis_tpu/utils/event_filters.py``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np


def filter_by_n_hits(df_events: Any, min_hits: int = 2,
                     max_hits: Optional[int] = None) -> Any:
    """Keep events with n_hits in [min_hits, max_hits]."""
    mask = df_events["n_hits"] >= min_hits
    if max_hits is not None:
        mask &= df_events["n_hits"] <= max_hits
    return df_events[mask].copy()


def filter_by_channels(
    df_events: Any,
    required_channels: Sequence[int],
    exact: bool = False,
) -> Any:
    """Keep events containing all required channels (exact=True: only those)."""
    required = set(int(c) for c in required_channels)

    def ok(channels: Any) -> bool:
        present = set(int(c) for c in np.asarray(channels))
        if exact:
            return present == required
        return required.issubset(present)

    mask = df_events["channels"].apply(ok)
    return df_events[mask].copy()


def filter_by_time_span(df_events: Any, max_span_ns: float) -> Any:
    """Keep events whose total span (dt/ns) fits the window."""
    return df_events[df_events["dt/ns"] <= max_span_ns].copy()


def filter_coincidence(
    df_events: Any,
    channel_a: int,
    channel_b: int,
    max_dt_ns: float,
) -> Any:
    """Keep events where hits on two channels are within max_dt_ns
    (reference analog: the numba coincidence filter)."""

    def delta(row: Any) -> float:
        channels = np.asarray(row["channels"])
        ts = np.asarray(row["timestamps"], dtype=np.float64)
        a = ts[channels == channel_a]
        b = ts[channels == channel_b]
        if len(a) == 0 or len(b) == 0:
            return np.inf
        return float(np.min(np.abs(a[:, None] - b[None, :]))) / 1e3  # ps -> ns

    mask = df_events.apply(delta, axis=1) <= max_dt_ns
    return df_events[mask].copy()


def filter_events_by_function(
    df_events: Any,
    filter_func: Any,
    column: Optional[str] = None,
    use_vectorized: bool = True,
) -> Any:
    """Filter with an arbitrary predicate
    (reference: event_filters.py:71 filter_events_by_function).

    ``filter_func`` takes either a whole row (column=None) or one column's
    value. With ``column`` and ``use_vectorized``, the predicate is first
    tried on the column as a vector (Series/ndarray in, boolean mask out)
    and falls back to per-element apply when that raises.
    """
    if column is not None and use_vectorized:
        try:
            mask = filter_func(df_events[column])
            mask = np.asarray(mask, dtype=bool)
            if mask.shape == (len(df_events),):
                return df_events[mask].copy()
        except Exception:
            pass
    if column is not None:
        mask = df_events[column].apply(filter_func)
    else:
        mask = df_events.apply(filter_func, axis=1)
    return df_events[np.asarray(mask, dtype=bool)].copy()


def filter_coincidence_events(
    df_events: Any,
    channels: Sequence[int],
) -> Any:
    """Keep events containing ALL the given channels
    (reference: event_filters.py:110 filter_coincidence_events; the
    reference's numba loop becomes a vectorized membership test over the
    per-event channel arrays)."""
    return filter_by_channels(df_events, channels, exact=False)


def extract_channel_attributes(
    df_filtered: Any,
    channels: Sequence[int],
    attribute: str = "areas",
) -> dict:
    """Per-channel attribute extraction from grouped events
    (reference: event_filters.py:169): returns
    ``{channel: [value, ...]}`` taking the FIRST hit on each channel per
    event, skipping events where the channel is absent."""
    result: dict = {int(ch): [] for ch in channels}
    ch_col = df_filtered["channels"].to_numpy() \
        if hasattr(df_filtered["channels"], "to_numpy") \
        else np.asarray(df_filtered["channels"], dtype=object)
    at_col = df_filtered[attribute].to_numpy() \
        if hasattr(df_filtered[attribute], "to_numpy") \
        else np.asarray(df_filtered[attribute], dtype=object)
    for chs, vals in zip(ch_col, at_col):
        chs = np.asarray(chs, dtype=np.int64)
        vals = np.asarray(vals)
        for ch in result:
            idx = np.flatnonzero(chs == ch)
            if idx.size:
                result[ch].append(vals[idx[0]])
    return result


def filter_by_area(
    df_events: Any,
    min_total_area: Optional[float] = None,
    max_total_area: Optional[float] = None,
) -> Any:
    """Keep events by total (summed) area."""
    totals = df_events["areas"].apply(lambda a: float(np.sum(np.asarray(a))))
    mask = np.ones(len(df_events), dtype=bool)
    if min_total_area is not None:
        mask &= (totals >= min_total_area).to_numpy()
    if max_total_area is not None:
        mask &= (totals <= max_total_area).to_numpy()
    return df_events[mask].copy()
