"""Threshold-crossing hit detection.

Port of ``waveformanalysis_tpu/ops/hits.py::threshold_hits_batch``:
signal >= per-event threshold marks samples; contiguous runs form hits;
each run extends by left/right extensions clipped to the padded window;
per hit: position = argmax of the extended segment (first occurrence),
height = that max, integral = sum(max(segment, 0)). Runs compact into a
fixed (n, K) capacity; n_runs counts them all, so overflow is visible.
"""

from __future__ import annotations

from typing import Dict

import torch

from waveformanalysis_tpu_torch.ops.peaks import compact_first_k

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
