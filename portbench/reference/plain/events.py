"""The event layer from its definitions: the same-channel hit merge, the
multi-channel events (df_events), the coincidence of hit windows
(hit_grouped) and the cross-channel pairing (df_paired). Each is a plain
loop over rows sorted by the quantity that defines it, written from what
the tables mean and not from the program's code. Imports nothing of the
program.

A hit's window is absolute: from ``timestamp + (start - position) * dt``
to ``timestamp + (end - position) * dt`` in ps, with ``dt`` in ns. All of
it is integer arithmetic here (the ps values stay far below 2**53).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

MERGED_DTYPES = {"position": np.int64, "height": np.float32, "integral": np.float32,
                 "sample_start": np.int32, "sample_end": np.int32, "width": np.float32,
                 "dt": np.int32, "rise_time": np.float32, "fall_time": np.float32,
                 "timestamp": np.int64, "board": np.int16, "channel": np.int16,
                 "record_id": np.int64}


def _windows(ts, pos, start, end, dt) -> Tuple[list, list]:
    """Each row's absolute window (start, end) in ps, as Python ints."""
    step = np.asarray(dt, np.int64) * 1000
    ts, pos = np.asarray(ts, np.int64), np.asarray(pos, np.int64)
    return ((ts + (np.asarray(start, np.int64) - pos) * step).tolist(),
            (ts + (np.asarray(end, np.int64) - pos) * step).tolist())


def merge_hits(hits: Dict[str, np.ndarray], merge_gap_ns: float,
               max_total_width_ns: float):
    """Same-channel merge of threshold hits.

    Per (board, channel), in ascending order of ``board * 2**32 + channel``,
    the hits are taken by the start of their windows (then by row). A hit
    joins the open cluster when merging is on (a gap above 0), its ``dt``
    is that of the hit before it, it starts no more than the gap after the
    cluster's latest end, and the cluster with it spans no more than the
    widest merge; otherwise it opens a cluster. A cluster's row is its
    tallest hit's (the earliest of equal heights), with the members'
    summed integral and, where all come from one record, their joint
    sample span (else -1). Returns the merged columns (with each cluster's
    component offset and count) and the (cluster, hit) pairs in order.
    """
    gap = float(merge_gap_ns) * 1e3
    widest = float(max_total_width_ns) * 1e3
    col = {k: np.asarray(v) for k, v in hits.items()}
    n = len(col["timestamp"])
    starts, ends = _windows(col["timestamp"], col["position"], col["edge_start"],
                            col["edge_end"], col["dt"])
    dt = col["dt"].tolist()
    by_channel: Dict[int, List[int]] = {}
    for i, key in enumerate((col["board"].astype(np.int64) * (1 << 32)
                             + col["channel"].astype(np.int64)).tolist()):
        by_channel.setdefault(key, []).append(i)

    clusters: List[List[int]] = []
    for key in sorted(by_channel):
        current: List[int] = []
        start0 = end_run = 0
        for i in sorted(by_channel[key], key=lambda i: (starts[i], i)):
            s, e = starts[i], ends[i]
            if (current and gap > 0 and dt[i] == dt[current[-1]] and s - end_run <= gap
                    and max(end_run, e) - start0 <= widest):
                current.append(i)
                end_run = max(end_run, e)
            else:
                if current:
                    clusters.append(current)
                current, start0, end_run = [i], s, e
        if current:
            clusters.append(current)

    # a cluster's row is its anchor hit's values; clusters of several hits
    # then take the merged height, integral and span
    height, ts = col["height"].tolist(), col["timestamp"].tolist()
    anchors = []
    for members in clusters:
        if len(members) == 1:
            anchors.append(members[0])
            continue
        tallest = max(height[i] for i in members)
        anchors.append(min((i for i in members if height[i] == tallest),
                           key=lambda i: ts[i]))
    a = np.asarray(anchors, dtype=np.int64)
    source = {"sample_start": "edge_start", "sample_end": "edge_end"}
    merged = {k: col[source.get(k, k)][a].astype(t) for k, t in MERGED_DTYPES.items()}
    for c, members in enumerate(clusters):
        if len(members) == 1:
            continue
        merged["integral"][c] = sum(float(col["integral"][i]) for i in members)
        if len({int(col["record_id"][i]) for i in members}) == 1:
            start = min(int(col["edge_start"][i]) for i in members)
            end = max(int(col["edge_end"][i]) for i in members)
            merged["sample_start"][c], merged["sample_end"][c] = start, end
            merged["width"][c] = max(end - start, 0)
        else:
            merged["sample_start"][c] = merged["sample_end"][c] = -1
            merged["width"][c] = -1.0
    sizes = np.asarray([len(m) for m in clusters], dtype=np.int64)
    merged["component_offset"] = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
        np.int64) if n else np.zeros(0, np.int64)
    merged["component_count"] = sizes.astype(np.int32)
    pairs = np.asarray([(c, i) for c, m in enumerate(clusters) for i in m],
                       dtype=np.int64).reshape(-1, 2)
    return merged, pairs


def _cells(values: np.ndarray, order: List[int], bounds: List[int]) -> list:
    """Per-event arrays: ``values`` taken in ``order``, cut at ``bounds``."""
    flat = values[np.asarray(order, dtype=np.int64)]
    return [flat[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]


def df_events(df, time_window_ns: float):
    """Multi-channel events of a (timestamp, channel, area, height) table.

    Rows in time order (then by row); an event opens at the first row not
    yet taken and holds every row at most the window after it. Its cells
    list its rows by channel (then in time order); t_min and t_max are its
    first and last timestamps.
    """
    import pandas as pd

    window = float(time_window_ns) * 1e3
    ts = df["timestamp"].to_numpy().astype(np.int64)
    ch = df["channel"].to_numpy()
    t = ts.tolist()
    events: List[List[int]] = []
    for i in sorted(range(len(t)), key=lambda i: (t[i], i)):
        if events and t[i] - t[events[-1][0]] <= window:
            events[-1].append(i)
        else:
            events.append([i])
    chans = ch.tolist()
    inner = [[e[j] for j in sorted(range(len(e)), key=lambda j, e=e: (chans[e[j]], j))]
             for e in events]
    flat = [i for e in inner for i in e]
    bounds = list(np.cumsum([0] + [len(e) for e in events]))
    t_min = np.asarray([t[e[0]] for e in events], dtype=np.int64)
    t_max = np.asarray([t[e[-1]] for e in events], dtype=np.int64)
    return pd.DataFrame({
        "event_id": np.arange(len(events), dtype=np.int64),
        "t_min": t_min, "t_max": t_max, "dt/ns": (t_max - t_min) / 1e3,
        "n_hits": np.asarray([len(e) for e in events], dtype=np.int32),
        "channels": _cells(ch, flat, bounds),
        "areas": _cells(df["area"].to_numpy(), flat, bounds),
        "heights": _cells(df["height"].to_numpy(), flat, bounds),
        "timestamps": _cells(ts, flat, bounds)})


def hit_grouped(merged: Dict[str, np.ndarray], time_window_ns: float,
                components: np.ndarray, component_hits: Dict[str, np.ndarray]):
    """Coincidences of merged hits' windows.

    A merged row whose sample span is -1 (its hits from several records)
    takes the span of its component hits' windows. Rows are taken by the
    start of their windows (then dt, timestamp, record id, row); a row
    joins the open event when it starts no more than the window after the
    latest end in it. Its cells list its rows by board, channel, dt, start,
    timestamp and record id; t_min and t_max are the earliest start and the
    latest end.
    """
    import pandas as pd

    gap = float(time_window_ns) * 1e3
    m = {k: np.asarray(v) for k, v in merged.items()}
    n = len(m["timestamp"])
    start, end = _windows(m["timestamp"], m["position"], m["sample_start"],
                          m["sample_end"], m["dt"])
    spanless = np.flatnonzero((m["sample_start"] < 0) | (m["sample_end"] < 0)).tolist()
    if spanless:
        c_start, c_end = _windows(component_hits["timestamp"], component_hits["position"],
                                  component_hits["edge_start"], component_hits["edge_end"],
                                  component_hits["dt"])
        parts: Dict[int, List[int]] = {}
        for c, h in components.tolist():
            parts.setdefault(c, []).append(h)
        for r in spanless:
            start[r] = min(c_start[h] for h in parts[r])
            end[r] = max(c_end[h] for h in parts[r])
    dt, ts, rid = m["dt"].tolist(), m["timestamp"].tolist(), m["record_id"].tolist()
    board, chan = m["board"].tolist(), m["channel"].tolist()
    events: List[List[int]] = []
    latest = 0
    for r in sorted(range(n), key=lambda r: (start[r], dt[r], ts[r], rid[r], r)):
        if events and start[r] <= latest + gap:
            events[-1].append(r)
            latest = max(latest, end[r])
        else:
            events.append([r])
            latest = end[r]
    inner = [sorted(e, key=lambda r: (board[r], chan[r], dt[r], start[r], ts[r], rid[r], r))
             for e in events]
    flat = [r for e in inner for r in e]
    bounds = list(np.cumsum([0] + [len(e) for e in events]))
    t_min = np.asarray([min(start[r] for r in e) for e in events], dtype=np.int64)
    t_max = np.asarray([max(end[r] for r in e) for e in events], dtype=np.int64)
    return pd.DataFrame({
        "event_id": np.arange(len(events), dtype=np.int64),
        "t_min": t_min, "t_max": t_max, "dt/ns": (t_max - t_min) / 1e3,
        "n_hits": np.asarray([len(e) for e in events], dtype=np.int64),
        "dt": _cells(m["dt"].astype(np.int32), flat, bounds),
        "boards": _cells(m["board"].astype(np.int16), flat, bounds),
        "channels": _cells(m["channel"].astype(np.int16), flat, bounds),
        "heights": _cells(m["height"].astype(np.float32), flat, bounds),
        "integrals": _cells(m["integral"].astype(np.float32), flat, bounds),
        "timestamps": _cells(m["timestamp"].astype(np.int64), flat, bounds),
        "record_ids": _cells(m["record_id"].astype(np.int64), flat, bounds),
        "sample_starts": _cells(m["sample_start"].astype(np.int32), flat, bounds),
        "sample_ends": _cells(m["sample_end"].astype(np.int32), flat, bounds)})


def df_paired(events, time_window_ns: float, n_channels: int, start_channel: int):
    """The events that span no more than the window, with delta_t (their
    last cell timestamp less the first, in ns) and, for each i below
    ``n_channels``, ``area_ch{start_channel + i}`` and ``height_ch...``:
    the i-th cell of the event, NaN where it has fewer (a column with a NaN
    is float64, one without keeps the cells' dtype)."""
    kept = events[events["dt/ns"] <= time_window_ns].copy()
    if kept.empty:
        return kept
    ts = list(kept["timestamps"])
    kept["delta_t"] = [(int(t[-1]) - int(t[0])) / 1000.0 if len(t) else np.nan for t in ts]
    for i in range(n_channels):
        for name, cells in (("area", list(kept["areas"])), ("height", list(kept["heights"]))):
            if all(len(c) > i for c in cells):
                values = np.asarray([c[i] for c in cells], dtype=cells[0].dtype)
            else:
                values = np.asarray([c[i] if len(c) > i else np.nan for c in cells],
                                    dtype=np.float64)
            kept[f"{name}_ch{start_channel + i}"] = values
    return kept
