"""Threshold-crossing hit detection.

Port of ``waveformanalysis_tpu/ops/hits.py::threshold_hits_batch``:
signal >= per-event threshold marks samples; contiguous runs form hits;
each run extends by left/right extensions clipped to the padded window;
per hit: position = argmax of the extended segment (first occurrence),
height = that max, integral = sum(max(segment, 0)). Runs compact into a
fixed (n, K) capacity; n_runs counts them all, so overflow is visible.
``compact_threshold_hits`` and ``threshold_columns_from_flat`` are the host
(NumPy) helpers that turn run slot tables into THRESHOLD_HIT columns.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from waveformanalysis_tpu_torch.ops.peaks import compact_first_k

KERNEL_VERSION = "hits-v1"
DEFAULT_MAX_HITS = 32


def threshold_hits_batch(
    signal: torch.Tensor,
    thresholds: torch.Tensor,
    valid_length: torch.Tensor,
    left_extension: int = 2,
    right_extension: int = 2,
    max_hits: int = DEFAULT_MAX_HITS,
) -> Dict[str, torch.Tensor]:
    """Find threshold runs over a (n, L) signal batch.

    Returns (n, K) tensors: valid, position, height, integral, seg_start,
    seg_end, run_start, run_end; plus (n,) n_runs (int32).
    """
    x = signal.to(torch.float32)
    n, L = x.shape
    K = max_hits
    dev = x.device
    i32 = torch.int32
    pos = torch.arange(L, device=dev, dtype=i32)[None, :]
    mask = (x >= thresholds[:, None]) & (pos < valid_length[:, None])

    zcol = torch.zeros((n, 1), dtype=torch.bool, device=dev)
    prev = torch.cat([zcol, mask[:, :-1]], dim=1)
    nxt = torch.cat([mask[:, 1:], zcol], dim=1)
    is_start = mask & ~prev
    is_end = mask & ~nxt  # inclusive last sample of the run
    n_runs = is_start.sum(dim=1, dtype=i32)

    pos_b = pos.expand(n, L)
    (starts,), s_ok = compact_first_k(is_start, (pos_b,), K, (0,))
    (ends_incl,), e_ok = compact_first_k(is_end, (pos_b,), K, (0,))
    run_valid = s_ok & e_ok
    ends = ends_incl + 1  # exclusive

    seg_start = (starts - left_extension).clamp(min=0)
    seg_end = (ends + right_extension).clamp(max=L)

    heights = torch.zeros((n, K), dtype=torch.float32, device=dev)
    integrals = torch.zeros((n, K), dtype=torch.float32, device=dev)
    positions = torch.zeros((n, K), dtype=i32, device=dev)
    x_pos = x.clamp(min=0.0)
    # loop only to the batch-max run count
    kmax = min(K, int(n_runs.max())) if n else 0
    for k in range(kmax):
        m = (pos >= seg_start[:, k][:, None]) & (pos < seg_end[:, k][:, None])
        seg_vals = torch.where(m, x, float("-inf"))
        mx, am = seg_vals.max(dim=1)  # first occurrence, like np.argmax
        ok = run_valid[:, k]
        heights[:, k] = torch.where(ok, mx, 0.0)
        integrals[:, k] = torch.where(ok, torch.where(m, x_pos, 0.0).sum(dim=1), 0.0)
        positions[:, k] = torch.where(ok, am.to(i32), 0)

    return {
        "valid": run_valid,
        "position": positions,
        "height": heights,
        "integral": integrals,
        "seg_start": seg_start,
        "seg_end": seg_end,
        "run_start": starts,
        "run_end": ends,
        "n_runs": n_runs,
    }


def compact_threshold_hits(
    results: Dict[str, np.ndarray],
    timestamps: np.ndarray,
    boards: np.ndarray,
    channels: np.ndarray,
    record_ids: np.ndarray,
    dt_ns: np.ndarray,
    record_lengths: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Flatten (n, K) run results into flat THRESHOLD_HIT columns (host)."""
    valid = np.asarray(results["valid"])
    rows, cols = np.nonzero(valid)
    return threshold_columns_from_flat(
        rows=rows,
        position=np.asarray(results["position"])[rows, cols],
        height=np.asarray(results["height"])[rows, cols],
        integral=np.asarray(results["integral"])[rows, cols],
        seg_start=np.asarray(results["seg_start"])[rows, cols],
        seg_end=np.asarray(results["seg_end"])[rows, cols],
        run_start=np.asarray(results["run_start"])[rows, cols],
        run_end=np.asarray(results["run_end"])[rows, cols],
        timestamps=timestamps, boards=boards, channels=channels,
        record_ids=record_ids, dt_ns=dt_ns, record_lengths=record_lengths,
    )


def threshold_columns_from_flat(
    rows: np.ndarray,
    position: np.ndarray,
    height: np.ndarray,
    integral: np.ndarray,
    seg_start: np.ndarray,
    seg_end: np.ndarray,
    run_start: np.ndarray,
    run_end: np.ndarray,
    timestamps: np.ndarray,
    boards: np.ndarray,
    channels: np.ndarray,
    record_ids: np.ndarray,
    dt_ns: np.ndarray,
    record_lengths: np.ndarray,
) -> Dict[str, np.ndarray]:
    """THRESHOLD_HIT columns from already-compacted per-run slot values.

    ``rows`` maps each run to its source waveform (row-major slot order —
    the order ``np.nonzero(valid)`` produces). Shared by the host compaction
    above and the device-compacted fused-bundle transfer path.
    """
    pos = np.asarray(position).astype(np.int64)
    start = np.asarray(run_start).astype(np.int64)
    end = np.asarray(run_end).astype(np.int64)
    seg_s = np.asarray(seg_start).astype(np.int64)
    seg_e = np.asarray(seg_end).astype(np.int64)
    dt = np.asarray(dt_ns, dtype=np.int64)[rows]
    rec_len = np.asarray(record_lengths, dtype=np.int64)[rows]

    edge_start = np.clip(seg_s, 0, rec_len)
    edge_end = np.maximum(np.clip(seg_e, 0, rec_len), edge_start)

    return {
        "position": pos,
        "height": np.asarray(height).astype(np.float32),
        "integral": np.asarray(integral).astype(np.float32),
        "edge_start": edge_start.astype(np.int32),
        "edge_end": edge_end.astype(np.int32),
        "width": (edge_end - edge_start).astype(np.float32),
        "dt": dt.astype(np.int32),
        "rise_time": (np.maximum(pos - start, 0) * dt).astype(np.float32),
        "fall_time": (np.maximum((end - 1) - pos, 0) * dt).astype(np.float32),
        "timestamp": np.asarray(timestamps, dtype=np.int64)[rows] + pos * dt * 1000,
        "board": np.asarray(boards, dtype=np.int16)[rows],
        "channel": np.asarray(channels, dtype=np.int16)[rows],
        "record_id": np.asarray(record_ids, dtype=np.int64)[rows],
    }
