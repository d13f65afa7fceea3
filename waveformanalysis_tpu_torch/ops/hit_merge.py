"""Same-channel time clustering of threshold hits.

Behavioral analog of the reference hit-merge layer
(reference: waveform_analysis/core/plugins/builtin/cpu/hit_merge.py:115-324):
per hardware channel, hits sorted by absolute start time cluster greedily —
a hit joins the open cluster iff merge_gap > 0, its dt matches, the gap to
the cluster's running end is <= merge_gap, and the total width stays within
max_total_width; merged rows take the highest (earliest on ties) hit as
anchor, summed integrals, and the union sample window (only when all
components share one record).

Hits are orders of magnitude fewer than samples, so this runs host-side with
a vectorized first pass (gap-rule segmentation via cumulative maxima) and a
narrow sequential fallback only for clusters that overflow max_total_width.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from waveformanalysis_tpu_torch.hardware import group_indices_by_hardware_channel

KERNEL_VERSION = "hit-merge-v1"


def _abs_windows(
    timestamps: np.ndarray,
    positions: np.ndarray,
    edge_start: np.ndarray,
    edge_end: np.ndarray,
    dt_ns: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Absolute ps start/end of each hit window
    (reference: hit_merge.py:68-93)."""
    dt_ps = dt_ns.astype(np.float64) * 1e3
    start = timestamps.astype(np.float64) + (edge_start - positions) * dt_ps
    end = timestamps.astype(np.float64) + (edge_end - positions) * dt_ps
    return start, end


def cluster_channel_hits(
    abs_start: np.ndarray,
    abs_end: np.ndarray,
    dt_ps: np.ndarray,
    merge_gap_ps: float,
    max_width_ps: float,
) -> np.ndarray:
    """Cluster ids (0..) for hits of ONE channel already sorted by abs_start.

    Vectorized gap segmentation; sequential width re-split only where needed.
    """
    n = len(abs_start)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if merge_gap_ps <= 0:
        return np.arange(n, dtype=np.int64)

    run_end = np.maximum.accumulate(abs_end)
    gap = abs_start[1:] - run_end[:-1]
    new_cluster = (gap > merge_gap_ps) | (dt_ps[1:] != dt_ps[:-1])
    ids = np.concatenate([[0], np.cumsum(new_cluster)]).astype(np.int64)

    # enforce max_total_width per cluster (rare: only oversized clusters loop)
    out = ids.copy()
    next_id = int(ids.max()) + 1
    for cid in np.unique(ids):
        idx = np.flatnonzero(ids == cid)
        if len(idx) < 2:
            continue
        start0 = abs_start[idx[0]]
        end_run = abs_end[idx[0]]
        cur = out[idx[0]]
        for j in idx[1:]:
            nxt_end = max(end_run, abs_end[j])
            if (abs_start[j] - end_run <= merge_gap_ps
                    and (nxt_end - start0) <= max_width_ps):
                out[j] = cur
                end_run = nxt_end
            else:
                cur = next_id
                next_id += 1
                out[j] = cur
                start0 = abs_start[j]
                end_run = abs_end[j]
    # renumber to consecutive in first-appearance order
    _, first_idx, inverse = np.unique(out, return_index=True, return_inverse=True)
    order = np.argsort(first_idx)
    remap = np.empty(len(order), dtype=np.int64)
    remap[order] = np.arange(len(order))
    return remap[inverse]


def merge_hits(
    hits: Dict[str, np.ndarray],
    merge_gap_ns: float,
    max_total_width_ns: float = 1e12,
    explicit_dt: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """Cluster + merge hit columns.

    hits: dict with position, height, integral, edge_start, edge_end, width,
    dt, rise_time, fall_time, timestamp, board, channel, record_id.

    Returns (merged_columns, cluster_rows, component_rows) where cluster_rows
    = (cluster_index, hit_index) pairs and component_rows = (merged_index,
    hit_index) pairs, both in emission order.
    """
    n = len(hits["timestamp"])
    empty_pairs = np.zeros((0, 2), dtype=np.int64)
    if n == 0:
        return _empty_merged(), empty_pairs, empty_pairs

    # data-first dt, matching the reference's require_dt_array
    # (cpu/_dt_compat.py:52-74): rows carry dt when present; explicit_dt is
    # only the migration fallback for inputs LACKING the field. The inverted
    # precedence (config over rows) was invisible at default dt and surfaced
    # only when a dt override composed with merging (fuzz differential).
    if "dt" in hits:
        dt = np.asarray(hits["dt"], dtype=np.int64)
    elif explicit_dt is not None:
        dt = np.full(n, int(explicit_dt), dtype=np.int64)
    else:
        raise ValueError(
            "[hit_merged] input hits are missing required field 'dt'; "
            "provide explicit config 'dt' for this migration period."
        )
    positions = np.asarray(hits["position"], dtype=np.float64)
    e_start = np.asarray(hits["edge_start"], dtype=np.float64)
    e_end = np.asarray(hits["edge_end"], dtype=np.float64)
    ts = np.asarray(hits["timestamp"], dtype=np.int64)
    abs_start, abs_end = _abs_windows(ts, positions, e_start, e_end, dt)
    dt_ps = dt.astype(np.float64) * 1e3

    merge_gap_ps = merge_gap_ns * 1e3
    max_width_ps = max_total_width_ns * 1e3

    boards = np.asarray(hits.get("board", np.zeros(n, np.int16)))
    channels = np.asarray(hits["channel"])

    cluster_rows: List[Tuple[int, int]] = []
    merged_rows: List[Dict[str, Any]] = []
    component_rows: List[Tuple[int, int]] = []
    global_cluster = 0

    for _hw, idx in group_indices_by_hardware_channel(boards, channels).items():
        order = idx[np.argsort(abs_start[idx], kind="stable")]
        ids = cluster_channel_hits(
            abs_start[order], abs_end[order], dt_ps[order],
            merge_gap_ps, max_width_ps,
        )
        for cid in range(int(ids.max()) + 1 if len(ids) else 0):
            members = order[ids == cid]
            ci = global_cluster
            global_cluster += 1
            for m in members:
                cluster_rows.append((ci, int(m)))
            merged_rows.append(_emit_cluster(hits, members, dt))

    # assemble merged columns + component table
    merged = _stack_merged(merged_rows)
    comp_offset = 0
    offsets = []
    for mi, row in enumerate(merged_rows):
        offsets.append(comp_offset)
        for hi in row["_members"]:
            component_rows.append((mi, int(hi)))
        comp_offset += len(row["_members"])
    merged["component_offset"] = np.asarray(offsets, dtype=np.int64)
    merged["component_count"] = np.asarray(
        [len(r["_members"]) for r in merged_rows], dtype=np.int32
    )
    cluster_arr = np.asarray(cluster_rows, dtype=np.int64).reshape(-1, 2)
    comp_arr = np.asarray(component_rows, dtype=np.int64).reshape(-1, 2)
    return merged, cluster_arr, comp_arr


def _emit_cluster(hits: Dict[str, np.ndarray], members: np.ndarray,
                  dt: np.ndarray) -> Dict[str, Any]:
    """One merged row (reference: hit_merge.py:256-324)."""
    if len(members) == 1:
        i = int(members[0])
        return {
            "_members": members,
            "position": int(hits["position"][i]),
            "height": float(hits["height"][i]),
            "integral": float(hits["integral"][i]),
            "sample_start": int(hits["edge_start"][i]),
            "sample_end": int(hits["edge_end"][i]),
            "width": float(hits["width"][i]) if "width" in hits else float(
                hits["edge_end"][i] - hits["edge_start"][i]),
            "dt": int(dt[i]),
            "rise_time": float(hits.get("rise_time", np.zeros(1))[i]
                               if "rise_time" in hits else 0.0),
            "fall_time": float(hits.get("fall_time", np.zeros(1))[i]
                               if "fall_time" in hits else 0.0),
            "timestamp": int(hits["timestamp"][i]),
            "board": int(hits["board"][i]) if "board" in hits else 0,
            "channel": int(hits["channel"][i]),
            "record_id": int(hits["record_id"][i]),
        }

    heights = np.asarray(hits["height"], dtype=np.float64)[members]
    max_h = float(heights.max())
    cands = members[heights == max_h]
    if len(cands) > 1:
        ts = np.asarray(hits["timestamp"], dtype=np.int64)[cands]
        anchor = int(cands[np.argmin(ts)])
    else:
        anchor = int(cands[0])

    rids = set(int(hits["record_id"][m]) for m in members)
    if len(rids) == 1:
        s_start = int(min(hits["edge_start"][m] for m in members))
        s_end = int(max(hits["edge_end"][m] for m in members))
        width = float(max(s_end - s_start, 0))
    else:
        s_start, s_end, width = -1, -1, -1.0

    return {
        "_members": members,
        "position": int(hits["position"][anchor]),
        "height": max_h,
        "integral": float(np.sum(np.asarray(hits["integral"])[members])),
        "sample_start": s_start,
        "sample_end": s_end,
        "width": width,
        "dt": int(dt[anchor]),
        "rise_time": float(hits["rise_time"][anchor]) if "rise_time" in hits else 0.0,
        "fall_time": float(hits["fall_time"][anchor]) if "fall_time" in hits else 0.0,
        "timestamp": int(hits["timestamp"][anchor]),
        "board": int(hits["board"][anchor]) if "board" in hits else 0,
        "channel": int(hits["channel"][anchor]),
        "record_id": int(hits["record_id"][anchor]),
    }


_MERGED_FIELDS = [
    ("position", np.int64), ("height", np.float32), ("integral", np.float32),
    ("sample_start", np.int32), ("sample_end", np.int32), ("width", np.float32),
    ("dt", np.int32), ("rise_time", np.float32), ("fall_time", np.float32),
    ("timestamp", np.int64), ("board", np.int16), ("channel", np.int16),
    ("record_id", np.int64),
]


def _stack_merged(rows: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    out = {}
    for name, dtype in _MERGED_FIELDS:
        out[name] = np.asarray([r[name] for r in rows], dtype=dtype)
    return out


def _empty_merged() -> Dict[str, np.ndarray]:
    out = {name: np.zeros(0, dtype=dtype) for name, dtype in _MERGED_FIELDS}
    out["component_offset"] = np.zeros(0, dtype=np.int64)
    out["component_count"] = np.zeros(0, dtype=np.int32)
    return out
