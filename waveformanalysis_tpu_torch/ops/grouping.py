"""Event grouping: time-window clustering and coincidence windows.

Behavioral analog of the reference event-grouping layer
(reference: waveform_analysis/core/processing/event_grouping.py:99-476):

- :func:`group_multi_channel_hits` — anchor-window clustering: the earliest
  unassigned hit opens an event; every hit within ``time_window_ns`` of it
  joins; clusters sort internally by channel. Replaces the numba boundary
  loop with a searchsorted loop over *clusters* (not hits) plus fully
  vectorized per-cluster aggregation via np.split.
- :func:`group_hit_windows` — chained-gap coincidence over absolute hit
  windows [abs_start, abs_end]: a hit joins while its start <= running
  cluster end + gap. The running-max chain vectorizes via cummax.
- :func:`pair_events` — filter events whose span fits the window and emit
  per-channel area/height columns.

Port of ``waveformanalysis_tpu/ops/grouping.py``. ``backend="device"`` runs
the torch ops of :mod:`waveformanalysis_tpu_torch.ops.grouping_device` on
``device`` (default CUDA; the plugins pass their Context's device).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from waveformanalysis_tpu_torch.device import to_numpy
from waveformanalysis_tpu_torch.foundation.profiler import span as _span

KERNEL_VERSION = "grouping-v2"

# The JAX package's threshold, kept so that ``auto`` picks the same backend
# as the JAX package. On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
# grouping phase, ms host / device, mean of 2 in turns) the backends are
# close: 262,144 df rows, df_events 283.4 / 232.1, events 75.4 / 44.2,
# df_paired 100.4 / 102.3; 1,048,576 rows, df_events 1216.2 / 1165.8,
# events 374.0 / 232.5, df_paired 513.1 / 495.7 (the per-event object
# cells, built on the host by both, dominate). Explicit backend="device"
# remains for device-resident pipelines at any size.
DEVICE_BACKEND_MIN_ROWS = 1_000_000


def _resolve_backend(backend: str, n_rows: int) -> str:
    """auto|host|device -> host|device. Auto picks the device kernels for
    large tables (binary-lifting clustering, segment reductions) and the
    host oracles for small ones."""
    if backend == "host":
        return "host"
    if backend == "device":
        return "device"
    if backend != "auto":
        raise ValueError(f"unknown grouping backend: {backend!r}")
    return "device" if n_rows >= DEVICE_BACKEND_MIN_ROWS else "host"


def anchor_window_boundaries(ts_sorted: np.ndarray, window_ps: float) -> np.ndarray:
    """Cluster boundaries: each cluster = hits within window of its first hit.

    One BATCHED searchsorted computes every hit's window end (n log n), then
    the anchor chain is followed with pure O(1) indexing — the sequential
    dependence is irreducible, but each step is an array lookup instead of
    its own searchsorted call (was ~33 us/cluster of numpy dispatch).
    (reference: event_grouping.py:478-526 numba loop / :176-183 fallback)
    """
    n = len(ts_sorted)
    if n == 0:
        return np.array([0], dtype=np.int64)
    nxt = np.searchsorted(ts_sorted, ts_sorted + window_ps, side="right")
    jump = nxt.tolist()  # list indexing is ~3x faster than ndarray scalar
    boundaries = [0]
    curr = 0
    while curr < n:
        curr = jump[curr]
        boundaries.append(curr)
    return np.asarray(boundaries, dtype=np.int64)


def chained_gap_cluster_ids(
    abs_start_sorted: np.ndarray, abs_end_sorted: np.ndarray, gap_ps: float
) -> np.ndarray:
    """Cluster ids for window rows sorted by abs_start: join while
    start <= running_max(end) + gap (vectorized cummax chain)."""
    n = len(abs_start_sorted)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    run_end = np.maximum.accumulate(abs_end_sorted)
    new = abs_start_sorted[1:] > (run_end[:-1] + gap_ps)
    return np.concatenate([[0], np.cumsum(new)]).astype(np.int64)


def _group_events_core(
    df: Any, time_window_ns: float, backend: str, device: Any = None
) -> Optional[Dict[str, np.ndarray]]:
    """Shared grouping core: sort, cluster, channel-sort within clusters.

    Returns flat columns in EVENT-MAJOR, CHANNEL-SORTED-WITHIN-EVENT order
    (the exact order the df_events cells carry) plus boundaries and
    per-event t_min/t_max; None for an empty input.
    """
    time_window_ps = time_window_ns * 1e3
    with _span("grouping.sort"):
        df_sorted = df.sort_values("timestamp").reset_index(drop=True)
        ts_all = df_sorted["timestamp"].to_numpy()
        ch_all = df_sorted["channel"].to_numpy()
    area_col = "area" if "area" in df_sorted.columns else "charge"
    height_col = "height" if "height" in df_sorted.columns else "peak"
    if area_col not in df_sorted.columns or height_col not in df_sorted.columns:
        raise KeyError("df must contain area/height (or charge/peak) columns")

    n = len(df_sorted)
    if n == 0:
        return None

    with _span("grouping.cluster"):
        if _resolve_backend(backend, n) == "device":
            from waveformanalysis_tpu_torch.ops import grouping_device as GD

            eid = GD.anchor_window_event_ids(ts_all.astype(np.int64), time_window_ps,
                                             device=device)
            boundaries = GD.boundaries_from_event_ids(eid)
        else:
            boundaries = anchor_window_boundaries(ts_all.astype(np.int64), time_window_ps)
    n_events = len(boundaries) - 1
    with _span("grouping.gather"):
        event_of = np.repeat(np.arange(n_events), np.diff(boundaries))
        # channel-sort inside clusters with ONE global lexsort
        order = np.lexsort((ch_all, event_of))
        return {
            "boundaries": boundaries,
            "n_events": n_events,
            "event_of": event_of,  # already non-decreasing; order preserves it
            "ts_sorted": ts_all,  # time-sorted (for reduceat aggregates)
            "ts": ts_all[order],
            "channel": ch_all[order],
            "area": df_sorted[area_col].to_numpy()[order],
            "height": df_sorted[height_col].to_numpy()[order],
            "t_min": np.minimum.reduceat(ts_all, boundaries[:-1]),
            "t_max": np.maximum.reduceat(ts_all, boundaries[:-1]),
        }


def group_multi_channel_hits(
    df: Any,
    time_window_ns: float,
    use_numba: bool = True,  # accepted for API parity; vectorized regardless
    n_processes: Optional[int] = None,
    backend: str = "auto",
    device: Any = None,
) -> Any:
    """Cluster a (timestamp, channel, area, height) table into events.

    Returns a DataFrame with event_id, t_min, t_max, dt/ns, n_hits, and
    channel-sorted per-event arrays (channels, areas, heights, timestamps).
    """
    import pandas as pd

    core = _group_events_core(df, time_window_ns, backend, device)
    if core is None:
        return pd.DataFrame(columns=[
            "event_id", "t_min", "t_max", "dt/ns", "n_hits",
            "channels", "areas", "heights", "timestamps",
        ])

    boundaries = core["boundaries"]
    n_events = core["n_events"]
    # direct view slicing: np.split's swapaxes path costs ~25 us per piece
    bl = boundaries.tolist()
    pairs = list(zip(bl[:-1], bl[1:]))
    t_mins, t_maxs = core["t_min"], core["t_max"]

    with _span("grouping.frame"):
        return pd.DataFrame(
            {
                "event_id": np.arange(n_events, dtype=np.int64),
                "t_min": t_mins.astype(np.int64),
                "t_max": t_maxs.astype(np.int64),
                "dt/ns": (t_maxs - t_mins) / 1e3,
                "n_hits": np.diff(boundaries).astype(np.int32),
                "channels": [core["channel"][lo:hi] for lo, hi in pairs],
                "areas": [core["area"][lo:hi] for lo, hi in pairs],
                "heights": [core["height"][lo:hi] for lo, hi in pairs],
                "timestamps": [core["ts"][lo:hi] for lo, hi in pairs],
            }
        )


def group_events_columnar(
    df: Any,
    time_window_ns: float,
    backend: str = "auto",
    device: Any = None,
) -> Dict[str, np.ndarray]:
    """Columnar event grouping: events table + flat hits + offsets.

    The device-friendly alternative to df_events' per-event object cells (the
    reference's pandas contract, event_grouping.py:99-270): the SAME
    clustering emits two flat column sets the device kernels consume
    directly — no ragged python lists, no per-event DataFrame cell build.

    Returns:
      events: event_id, t_min, t_max, dt_ns, n_hits, hit_offset
      hits:   hit_event_id, hit_channel, hit_area, hit_height, hit_timestamp
              (event-major, channel-sorted within each event — bit-identical
              values/order to the df_events cells)
    """
    core = _group_events_core(df, time_window_ns, backend, device)
    if core is None:
        z = np.zeros(0, np.int64)
        return {
            "event_id": z, "t_min": z, "t_max": z,
            "dt_ns": np.zeros(0, np.float64),
            "n_hits": np.zeros(0, np.int32), "hit_offset": z,
            "hit_event_id": z, "hit_channel": np.zeros(0, np.int16),
            "hit_area": np.zeros(0, np.float32),
            "hit_height": np.zeros(0, np.float32), "hit_timestamp": z,
        }
    boundaries = core["boundaries"]
    return {
        "event_id": np.arange(core["n_events"], dtype=np.int64),
        "t_min": core["t_min"].astype(np.int64),
        "t_max": core["t_max"].astype(np.int64),
        "dt_ns": (core["t_max"] - core["t_min"]) / 1e3,
        "n_hits": np.diff(boundaries).astype(np.int32),
        "hit_offset": boundaries[:-1].astype(np.int64),
        "hit_event_id": core["event_of"].astype(np.int64),
        "hit_channel": core["channel"].astype(np.int16),
        # SOURCE dtype, no cast (f4 from the production kernels): forcing
        # f8 here made df_paired's columnar route diverge in dtype from
        # the classic (reference) path
        "hit_area": core["area"],
        "hit_height": core["height"],
        "hit_timestamp": core["ts"].astype(np.int64),
    }


def group_hit_windows(
    hits: Dict[str, np.ndarray],
    time_window_ns: float,
    dt_values: Optional[np.ndarray] = None,
    component_rows: Optional[Dict[str, np.ndarray]] = None,
    component_hits: Optional[Dict[str, np.ndarray]] = None,
    backend: str = "auto",
    device: Any = None,
) -> Any:
    """Group merged hits into coincidence events by absolute windows.

    hits columns: timestamp, position, board, channel, height, integral,
    record_id, dt, and sample_start/sample_end (or edge_start/edge_end).
    Invalid windows (negative edges from cross-record merges) recover their
    extent from the component hits.
    """
    import pandas as pd

    columns = ["event_id", "t_min", "t_max", "dt/ns", "n_hits", "dt",
               "boards", "channels", "heights", "integrals", "timestamps",
               "record_ids", "sample_starts", "sample_ends"]
    n = len(hits.get("timestamp", ()))
    if n == 0:
        return pd.DataFrame(columns=columns)
    if time_window_ns < 0:
        raise ValueError("time_window_ns must be >= 0")

    names = set(hits)
    if {"sample_start", "sample_end"}.issubset(names):
        s_name, e_name = "sample_start", "sample_end"
    elif {"edge_start", "edge_end"}.issubset(names):
        s_name, e_name = "edge_start", "edge_end"
    else:
        raise KeyError("hits missing sample_start/sample_end or edge_start/edge_end")
    required = {"timestamp", "position", "board", "channel", "height",
                "integral", "record_id"}
    missing = sorted(required - names)
    if missing:
        raise KeyError(f"hits missing required fields: {missing}")

    with _span("grouping.windows"):
        timestamps = np.asarray(hits["timestamp"], dtype=np.int64)
        positions = np.asarray(hits["position"], dtype=np.float64)
        if dt_values is None:
            if "dt" not in names:
                raise KeyError("hits missing required field: dt")
            dt_values = np.asarray(hits["dt"], dtype=np.int32)
        else:
            dt_values = np.asarray(dt_values, dtype=np.int32)
        if np.any(dt_values <= 0):
            raise ValueError("hit dt must be positive for every row")

        starts_rel = np.asarray(hits[s_name], dtype=np.int32)
        ends_rel = np.asarray(hits[e_name], dtype=np.int32)
        boards = np.asarray(hits["board"], dtype=np.int16)
        channels = np.asarray(hits["channel"], dtype=np.int16)
        heights = np.asarray(hits["height"], dtype=np.float32)
        integrals = np.asarray(hits["integral"], dtype=np.float32)
        record_ids = np.asarray(hits["record_id"], dtype=np.int64)

        dt_ps = dt_values.astype(np.float64) * 1e3
        abs_starts = timestamps.astype(np.float64) + (starts_rel - positions) * dt_ps
        abs_ends = timestamps.astype(np.float64) + (ends_rel - positions) * dt_ps

    invalid = (starts_rel < 0) | (ends_rel < 0)
    if np.any(invalid):
        with _span("grouping.components"):
            if component_rows is None or component_hits is None:
                raise ValueError(
                    "component_rows and component_hits are required when hit "
                    "windows contain invalid edges"
                )
            hit_idx = np.asarray(component_rows["hit_index"], dtype=np.int64)
            c_ts = np.asarray(component_hits["timestamp"], dtype=np.int64)
            c_pos = np.asarray(component_hits["position"], dtype=np.float64)
            c_dt = np.asarray(component_hits["dt"], dtype=np.int32)
            c_s = np.asarray(component_hits["edge_start"], dtype=np.int32)
            c_e = np.asarray(component_hits["edge_end"], dtype=np.int32)
            c_dt_ps = c_dt.astype(np.float64) * 1e3
            c_abs_s = c_ts.astype(np.float64) + (c_s - c_pos) * c_dt_ps
            c_abs_e = c_ts.astype(np.float64) + (c_e - c_pos) * c_dt_ps
            offsets = np.asarray(hits["component_offset"], dtype=np.int64)
            counts = np.asarray(hits["component_count"], dtype=np.int32)
            for mi in np.flatnonzero(invalid):
                off, cnt = int(offsets[mi]), int(counts[mi])
                if cnt <= 0:
                    raise ValueError(
                        f"missing hit_merged_components rows for hit_merged index {int(mi)}"
                    )
                subset = hit_idx[off : off + cnt]
                abs_starts[mi] = float(np.min(c_abs_s[subset]))
                abs_ends[mi] = float(np.max(c_abs_e[subset]))

    with _span("grouping.sort"):
        order = np.lexsort((record_ids, timestamps, dt_values, abs_starts))
    with _span("grouping.cluster"):
        gap_ps = time_window_ns * 1e3
        if _resolve_backend(backend, n) == "device":
            from waveformanalysis_tpu_torch.ops import grouping_device as GD

            ids_sorted = to_numpy(GD.chained_gap_cluster_ids(
                abs_starts[order], abs_ends[order], gap_ps, device=device
            )).astype(np.int64)
        else:
            ids_sorted = chained_gap_cluster_ids(abs_starts[order], abs_ends[order], gap_ps)
        n_events = int(ids_sorted[-1]) + 1 if len(ids_sorted) else 0

    with _span("grouping.gather"):
        # within-event ordering: boards, channels, dt, abs_start, timestamp, rid
        sub = order
        inner = np.lexsort((
            record_ids[sub], timestamps[sub], abs_starts[sub],
            dt_values[sub], channels[sub], boards[sub], ids_sorted,
        ))
        sub = sub[inner]
        ids_final = ids_sorted[inner]
        bounds = np.concatenate([[0], np.flatnonzero(np.diff(ids_final)) + 1, [len(sub)]])

        # columnar build: gather once in event order, then slice per-event views
        # (a per-event dict loop costs ~40 us/event in pandas construction)
        s_sorted = abs_starts[sub]
        e_sorted = abs_ends[sub]
        starts_at = bounds[:-1]
        t_mins = np.minimum.reduceat(s_sorted, starts_at).astype(np.int64)
        t_maxs = np.maximum.reduceat(e_sorted, starts_at).astype(np.int64)
        dt_g = dt_values[sub].astype(np.int32)
        boards_g = boards[sub]
        channels_g = channels[sub]
        heights_g = heights[sub]
        integrals_g = integrals[sub]
        timestamps_g = timestamps[sub]
        record_ids_g = record_ids[sub]
        ss_g = starts_rel[sub].astype(np.int32)
        se_g = ends_rel[sub].astype(np.int32)
    with _span("grouping.frame"):
        bl = bounds.tolist()
        pairs = list(zip(bl[:-1], bl[1:]))
        # per-event cells are COPIES: views into the shared gathered column
        # would let an in-place mutation of one event corrupt its neighbors
        return pd.DataFrame(
            {
                "event_id": np.arange(n_events, dtype=np.int64),
                "t_min": t_mins,
                "t_max": t_maxs,
                "dt/ns": (t_maxs - t_mins) / 1e3,
                "n_hits": np.diff(bounds).astype(np.int64),
                "dt": [dt_g[lo:hi].copy() for lo, hi in pairs],
                "boards": [boards_g[lo:hi].copy() for lo, hi in pairs],
                "channels": [channels_g[lo:hi].copy() for lo, hi in pairs],
                "heights": [heights_g[lo:hi].copy() for lo, hi in pairs],
                "integrals": [integrals_g[lo:hi].copy() for lo, hi in pairs],
                "timestamps": [timestamps_g[lo:hi].copy() for lo, hi in pairs],
                "record_ids": [record_ids_g[lo:hi].copy() for lo, hi in pairs],
                "sample_starts": [ss_g[lo:hi].copy() for lo, hi in pairs],
                "sample_ends": [se_g[lo:hi].copy() for lo, hi in pairs],
            },
            columns=columns,
        )


def _flat_cells(col: Any, dtype=None):
    """Ragged per-event cells -> (flat values, offsets, counts).

    ``dtype=None`` keeps the cells' own dtype (reference dtype parity: its
    paired columns carry the f4 kernel values straight through). Pass int64
    explicitly for ps timestamps: f64 would drop ULPs past 2**53."""
    vals = col.to_list() if hasattr(col, "to_list") else list(col)
    try:
        counts = np.fromiter((len(v) for v in vals), dtype=np.int64,
                             count=len(vals))
        # one concatenate over the raw per-event arrays, one cast —
        # a per-item asarray loop here costs ~3 us/event
        flat = np.concatenate(vals) if len(vals) else np.zeros(0, dtype)
    except (TypeError, ValueError):
        # tolerant path for None/scalar cells (treated as empty, like
        # the reference's get_val NaN fallback)
        cleaned = [
            np.atleast_1d(np.asarray(v))
            if hasattr(v, "__len__") and not isinstance(v, (str, bytes))
            else np.zeros(0, dtype or np.float64)
            for v in vals
        ]
        counts = np.fromiter((len(v) for v in cleaned), dtype=np.int64,
                             count=len(cleaned))
        flat = np.concatenate(cleaned) if cleaned else \
            np.zeros(0, dtype or np.float64)
    if dtype is not None and flat.dtype != dtype:
        flat = flat.astype(dtype)
    offsets = np.zeros(len(vals), dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    return flat, offsets, counts


def _restore_cell_dtype(col: np.ndarray, src_dtype) -> np.ndarray:
    """Reference dtype rule on a device-gathered (f8, NaN-filled) column:
    a column with no missing hits keeps the source cells' dtype (exact —
    the f8 values originated as that dtype); any NaN leaves it f8, the way
    pandas .apply upcasts the reference's columns."""
    if col.dtype != src_dtype and not np.isnan(col).any():
        return col.astype(src_dtype)
    return col


def _pair_events_device_path(
    df_events: Any,
    time_window_ns: float,
    n_channels: int,
    start_channel: int,
    device: Any = None,
) -> Any:
    """Device pairing: one pass of gathers over the flat event layout,
    host-filtered by the keep mask (host path is the parity oracle)."""
    from waveformanalysis_tpu_torch.ops import grouping_device as GD

    n = len(df_events)
    if n == 0:
        return df_events[df_events["dt/ns"] <= time_window_ns].copy()

    areas_key = "areas" if "areas" in df_events.columns else "charges"
    heights_key = "heights" if "heights" in df_events.columns else "peaks"
    a_triple = _flat_cells(df_events[areas_key])
    h_triple = _flat_cells(df_events[heights_key])
    out = GD.pair_events_device(
        _flat_cells(df_events["timestamps"], dtype=np.int64),
        a_triple,
        h_triple,
        np.asarray(df_events["dt/ns"], dtype=np.float64),
        time_window_ns,
        n_channels=n_channels,
        device=device,
    )
    keep = out["keep"]
    df_paired = df_events[keep].copy()
    if df_paired.empty:
        return df_paired
    if "delta_t" not in df_paired.columns:
        df_paired["delta_t"] = out["delta_t"][keep]
    for i in range(n_channels):
        df_paired[f"area_ch{start_channel + i}"] = _restore_cell_dtype(
            out["area_ch"][keep, i], a_triple[0].dtype)
        df_paired[f"height_ch{start_channel + i}"] = _restore_cell_dtype(
            out["height_ch"][keep, i], h_triple[0].dtype)
    return df_paired


def pair_events_columnar(
    events: Any,
    event_hits: Any,
    time_window_ns: float,
    n_channels: int,
    start_channel: int = 0,
    backend: str = "auto",
    device: Any = None,
) -> Any:
    """Pairing over the columnar (events + flat hits) representation.

    Same filter + derived columns as :func:`pair_events`, but consuming the
    flat layout directly — the per-event object cells never exist, so the
    returned DataFrame carries SCALAR columns only (event_id, t_min, t_max,
    dt/ns, n_hits, delta_t, area_ch*/height_ch*). The flat gathers run on
    device for backend=device (ops/grouping_device.pair_events_device).
    """
    import pandas as pd

    ev = {k: np.asarray(events[k]) for k in
          ("event_id", "t_min", "t_max", "dt_ns", "n_hits", "hit_offset")}
    hits = {k: np.asarray(event_hits[k]) for k in
            ("hit_timestamp", "hit_area", "hit_height")}
    n_events = len(ev["event_id"])
    offsets = ev["hit_offset"].astype(np.int64)
    counts = ev["n_hits"].astype(np.int64)
    span = ev["dt_ns"].astype(np.float64)

    if n_events and _resolve_backend(backend, n_events) == "device":
        from waveformanalysis_tpu_torch.ops import grouping_device as GD

        out = GD.pair_events_device(
            (hits["hit_timestamp"], offsets, counts),
            (hits["hit_area"], offsets, counts),
            (hits["hit_height"], offsets, counts),
            span, time_window_ns, n_channels=n_channels, device=device,
        )
        keep = out["keep"]
        delta_t = out["delta_t"]
        # per-channel COLUMNS (not a stacked matrix: stacking would upcast
        # an all-present f4 column next to a NaN-holding f8 one)
        area_cols = [_restore_cell_dtype(out["area_ch"][:, i],
                                         hits["hit_area"].dtype)
                     for i in range(n_channels)]
        height_cols = [_restore_cell_dtype(out["height_ch"][:, i],
                                           hits["hit_height"].dtype)
                       for i in range(n_channels)]
    else:
        keep = span <= time_window_ns
        has = counts > 0
        hi = max(len(hits["hit_timestamp"]) - 1, 0)
        ts_f = hits["hit_timestamp"]
        first = ts_f[np.clip(offsets, 0, hi)] if len(ts_f) else \
            np.zeros(n_events, np.int64)
        last = ts_f[np.clip(offsets + counts - 1, 0, hi)] if len(ts_f) else \
            np.zeros(n_events, np.int64)
        delta_t = np.where(has, (last - first) / 1000.0, np.nan)

        def take(flat, idx):
            # reference dtype rule: all-present keeps the source dtype,
            # any missing hit upcasts the column to f8 NaN (see _take)
            ok = counts > idx
            pos = np.minimum(offsets + idx, max(len(flat) - 1, 0))
            if len(flat) and ok.all():
                return flat[pos].copy()
            out_col = np.full(n_events, np.nan)
            if len(flat):
                out_col[ok] = flat[pos[ok]]
            return out_col

        area_cols = [take(hits["hit_area"], i) for i in range(n_channels)]
        height_cols = [take(hits["hit_height"], i) for i in range(n_channels)]

    cols = {
        "event_id": ev["event_id"][keep],
        "t_min": ev["t_min"][keep],
        "t_max": ev["t_max"][keep],
        "dt/ns": span[keep],
        "n_hits": ev["n_hits"][keep],
        "delta_t": delta_t[keep],
    }
    for i in range(n_channels):
        cols[f"area_ch{start_channel + i}"] = area_cols[i][keep]
        cols[f"height_ch{start_channel + i}"] = height_cols[i][keep]
    return pd.DataFrame(cols)


def pair_events(
    df_events: Any,
    time_window_ns: float,
    n_channels: int,
    start_channel: int = 0,
    backend: str = "auto",
    device: Any = None,
) -> Any:
    """Filter events whose span fits the window; add per-channel columns
    (reference: processing/analyzer.py:66-150).

    backend=device runs the per-event gathers (delta_t, area_ch*/height_ch*)
    as one pass of gathers over the flat (values, offsets, counts) layout
    (ops/grouping_device.pair_events_device); host is the parity oracle.
    Like the sibling grouping kernels, auto picks host below
    DEVICE_BACKEND_MIN_ROWS.
    """
    if _resolve_backend(backend, len(df_events)) == "device":
        return _pair_events_device_path(
            df_events, time_window_ns, n_channels, start_channel, device
        )
    with _span("grouping.filter"):
        df_paired = df_events[df_events["dt/ns"] <= time_window_ns].copy()
    if df_paired.empty:
        return df_paired

    # vectorized per-event array indexing: rebuild the flat value arrays
    # once + an offset table, then every derived column is a single gather.
    # The pandas .apply formulation this replaces cost ~5-10 us/row for
    # EACH of the 1 + 2*n_channels columns.
    _flat = _flat_cells

    def _take(flat, offsets, counts, idx):
        """value[idx] per event, NaN where the array is shorter.

        Reference dtype rule (analyzer.py:100-108 .apply inference): when
        every event has the channel the column keeps the cells' dtype
        (f4 from the kernels); any missing hit -> NaN upcasts it to f8.
        """
        ok = counts > idx
        pos = np.minimum(offsets + idx, max(len(flat) - 1, 0))
        if len(flat) and ok.all():
            return flat[pos].copy()
        out = np.full(len(counts), np.nan)
        if len(flat):
            out[ok] = flat[pos[ok]]
        return out

    with _span("grouping.pair"):
        if "delta_t" not in df_paired.columns:
            ts_flat, ts_off, ts_cnt = _flat(df_paired["timestamps"],
                                            dtype=np.int64)
            ok = ts_cnt > 0
            hi = max(len(ts_flat) - 1, 0)
            first = ts_flat[np.clip(ts_off, 0, hi)] if len(ts_flat) else \
                np.zeros(len(ts_cnt), np.int64)
            last = ts_flat[np.clip(ts_off + ts_cnt - 1, 0, hi)] \
                if len(ts_flat) else np.zeros(len(ts_cnt), np.int64)
            delta = (last - first) / 1000.0
            # empty timestamp cells -> NaN (the .apply formulation raised)
            df_paired["delta_t"] = np.where(ok, delta, np.nan)

        areas_key = "areas" if "areas" in df_paired.columns else "charges"
        heights_key = "heights" if "heights" in df_paired.columns else "peaks"
        a_flat, a_off, a_cnt = _flat(df_paired[areas_key])
        h_flat, h_off, h_cnt = _flat(df_paired[heights_key])
        for i in range(n_channels):
            df_paired[f"area_ch{start_channel + i}"] = _take(a_flat, a_off,
                                                             a_cnt, i)
            df_paired[f"height_ch{start_channel + i}"] = _take(h_flat, h_off,
                                                               h_cnt, i)
    return df_paired
