"""Device event-grouping ops: anchor-window clustering and chained-gap
coincidence in torch ops.

Port of ``waveformanalysis_tpu/ops/grouping_device.py``. The JAX package
writes these as jitted XLA functions, not Pallas kernels, so the port
writes them as torch ops on the caller's device. The host kernels in
:mod:`waveformanalysis_tpu_torch.ops.grouping` remain the parity oracles
(reference behavior: waveform_analysis/core/processing/event_grouping.py:
99-526, the numba boundary loop at :478).

Design
------
- The anchor-window chain (each cluster = hits within ``window`` of its
  first hit) is sequential in its naive form. Here it is binary lifting
  (pointer doubling): ``nxt[i] = searchsorted(ts, ts[i] + window, right)``
  is a monotone jump function, so jump tables ``J_k = nxt^(2^k)`` are built
  with log2(n) gathers, and every hit then finds its cluster ordinal with a
  log2(n)-step descent. O(n log n) parallel work, no sequential dependence.
- The chained-gap rule (join while start <= running-max(end) + gap) is a
  cumulative max in float64, compared in float64, plus a prefix sum.
- Timestamps are int64 picoseconds, native on the GPU. Fractional windows
  are floored to whole picoseconds first: for integer timestamps,
  ``d > w  <=>  d >= floor(w)+1``, so the integer-window search is exact
  for any non-negative float window.
- Output dtypes are the JAX package's: int32 ids and counts, int64
  timestamps, float64 values.

Every function takes ``device`` (default CUDA: the port runs on the card
unless the caller asks for the CPU) and returns host arrays where the JAX
function returns host arrays, tensors on ``device`` where it returns
device arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import resolve_device, to_device

KERNEL_VERSION = "grouping-device-v1"


def _on(x: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (tensor or array-like) as a contiguous ``dtype`` tensor on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    arr = np.asarray(x)
    if not arr.flags.writeable:  # torch.from_numpy wants writable memory
        arr = arr.copy()
    return to_device(arr, device).to(dtype).contiguous()


# ---------------------------------------------------------------------------
# anchor-window clustering (df_events)
# ---------------------------------------------------------------------------


def anchor_window_event_ids(ts_sorted: Any, window_ps: float,
                            device: Any = None) -> torch.Tensor:
    """Device event ids for anchor-window clustering.

    Parameters mirror :func:`waveformanalysis_tpu_torch.ops.grouping.
    anchor_window_boundaries`; returns an int32 per-hit event-id tensor on
    ``device`` (non-decreasing) instead of boundaries. ``event_id[i] = k``
    means hit ``i`` is in the cluster opened by anchor ``a_k`` (``a_0 = 0``,
    ``a_{k+1} = nxt[a_k]``).
    """
    if window_ps < 0:
        raise ValueError("window_ps must be >= 0")
    dev = resolve_device(device)
    n = int(len(ts_sorted))
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    ts = _on(ts_sorted, torch.int64, dev)
    # nxt[i] = first index whose timestamp exceeds ts[i] + window; strictly
    # > i because ts[i] <= ts[i] + window, so jumps always advance
    nxt = torch.searchsorted(ts, ts + int(np.floor(window_ps)), right=True)
    levels = max(1, n.bit_length())
    # sentinel row n is a fixed point so lifted tables stay in range
    jump = torch.cat([nxt, torch.tensor([n], dtype=torch.int64, device=dev)])
    tables = []
    for _ in range(levels):  # J_k = nxt^(2^k): one gather each
        tables.append(jump)
        jump = jump[jump]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    cnt = torch.zeros(n, dtype=torch.int64, device=dev)
    # descend from the largest stride: the number of anchor jumps from hit
    # 0 that stay <= i is exactly i's cluster ordinal
    for k in range(levels - 1, -1, -1):
        stepped = tables[k][pos]
        take = stepped <= idx
        pos = torch.where(take, stepped, pos)
        cnt = torch.where(take, cnt + (1 << k), cnt)
    return cnt.to(torch.int32)


def boundaries_from_event_ids(event_ids: Any) -> np.ndarray:
    """Host helper: convert a non-decreasing event-id array to boundaries
    compatible with :func:`grouping.anchor_window_boundaries`."""
    if isinstance(event_ids, torch.Tensor):
        event_ids = event_ids.cpu().numpy()
    event_ids = np.asarray(event_ids)
    n = len(event_ids)
    if n == 0:
        return np.array([0], dtype=np.int64)
    steps = np.flatnonzero(np.diff(event_ids)) + 1
    return np.concatenate([[0], steps, [n]]).astype(np.int64)


# ---------------------------------------------------------------------------
# chained-gap coincidence (hit_grouped)
# ---------------------------------------------------------------------------


def chained_gap_cluster_ids(abs_start_sorted: Any, abs_end_sorted: Any,
                            gap_ps: float, device: Any = None) -> torch.Tensor:
    """Device cluster ids (int32 tensor on ``device``) for rows sorted by
    abs_start: join while start <= running-max(end) + gap. Exact f64
    compare."""
    dev = resolve_device(device)
    n = int(len(abs_start_sorted))
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    s = _on(abs_start_sorted, torch.float64, dev)
    e = _on(abs_end_sorted, torch.float64, dev)
    run_end = torch.cummax(e, dim=0).values
    new = s[1:] > (run_end[:-1] + float(gap_ps))
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(new.to(torch.int32), dim=0, dtype=torch.int32)])


# ---------------------------------------------------------------------------
# fully on-device grouping with fixed-capacity per-event aggregates
# ---------------------------------------------------------------------------


def _segment(values: torch.Tensor, ids: torch.Tensor, num_segments: int,
             reduce: str, identity: Any) -> torch.Tensor:
    """``jax.ops.segment_<reduce>``: segments without a member hold the
    reduction's identity (scatter_reduce without ``include_self`` keeps
    whatever the output was filled with)."""
    out = torch.full((num_segments,), identity, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, ids, values, reduce=reduce, include_self=False)


def segment_aggregates(
    event_ids: torch.Tensor,
    timestamps: torch.Tensor,
    areas: torch.Tensor,
    heights: torch.Tensor,
    num_segments: int,
) -> Dict[str, torch.Tensor]:
    """Per-event aggregates via segment reductions, on the tensors' device.

    ``num_segments`` is a capacity (use n_hits as the safe bound). Returns
    padded tensors; rows >= n_events are zero (the JAX function's
    ``where(present, ..., 0)`` over the segment identities).
    """
    ids = event_ids.to(torch.int64)
    n_hits = torch.zeros(num_segments, dtype=torch.int32, device=ids.device).scatter_add(
        0, ids, torch.ones_like(ids, dtype=torch.int32))
    int_max = torch.iinfo(timestamps.dtype).max if not timestamps.is_floating_point() \
        else float("inf")
    int_min = torch.iinfo(timestamps.dtype).min if not timestamps.is_floating_point() \
        else float("-inf")
    t_min = _segment(timestamps, ids, num_segments, "amin", int_max)
    t_max = _segment(timestamps, ids, num_segments, "amax", int_min)
    area_sum = torch.zeros(num_segments, dtype=areas.dtype, device=ids.device).scatter_add(
        0, ids, areas)
    height_max = _segment(heights, ids, num_segments, "amax", float("-inf"))
    present = n_hits > 0
    zero = torch.zeros((), dtype=timestamps.dtype, device=ids.device)
    fzero = torch.zeros((), dtype=areas.dtype, device=ids.device)
    return {
        "n_hits": n_hits,
        "t_min": torch.where(present, t_min, zero),
        "t_max": torch.where(present, t_max, zero),
        "area_sum": torch.where(present, area_sum, fzero),
        "height_max": torch.where(present, height_max, fzero.to(heights.dtype)),
        "n_events": present.sum(),  # int64, as jnp.sum of int32 under x64
    }


def _gather_or_nan(flat: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """flat[idx] as float64 where ``ok``, NaN elsewhere (JAX clamps the
    index into range; an empty ``flat`` gives NaN everywhere)."""
    if flat.numel() == 0:
        return torch.full(idx.shape, float("nan"), dtype=torch.float64, device=idx.device)
    vals = flat[idx.clamp(0, flat.numel() - 1)].to(torch.float64)
    return torch.where(ok, vals, torch.full_like(vals, float("nan")))


def pair_events_device(
    ts: tuple,
    areas: tuple,
    heights: tuple,
    span_ns: np.ndarray,
    time_window_ns: float,
    n_channels: int,
    device: Any = None,
) -> Dict[str, np.ndarray]:
    """Device pairing pass over the flat (values, offsets, counts) event
    layout: ``ts``/``areas``/``heights`` are each such a triple. Returns
    host arrays: keep mask, delta_t, (n_events, n_channels) area/height
    matrices, NaN where an event has fewer hits than the channel index,
    matching the host oracle bit for bit."""
    dev = resolve_device(device)
    n_events = int(len(ts[1]))
    if n_events == 0:
        return {
            "keep": np.zeros(0, bool),
            "delta_t": np.zeros(0, np.float64),
            "area_ch": np.zeros((0, n_channels), np.float64),
            "height_ch": np.zeros((0, n_channels), np.float64),
        }
    ts_flat, ts_off, ts_cnt = (_on(x, torch.int64, dev) for x in ts)
    a_flat, h_flat = _on(areas[0], torch.float64, dev), _on(heights[0], torch.float64, dev)
    a_off, a_cnt = (_on(x, torch.int64, dev) for x in areas[1:])
    h_off, h_cnt = (_on(x, torch.int64, dev) for x in heights[1:])
    keep = _on(span_ns, torch.float64, dev) <= float(time_window_ns)
    # delta stays in integer ps on the device; the host performs the ns
    # division (bit parity with the host oracle)
    has = ts_cnt > 0
    if ts_flat.numel():
        hi = ts_flat.numel() - 1
        first = ts_flat[ts_off.clamp(0, hi)]
        last = ts_flat[(ts_off + ts_cnt - 1).clamp(0, hi)]
        delta_ps = torch.where(has, last - first, torch.zeros_like(first))
    else:
        delta_ps = torch.zeros(n_events, dtype=torch.int64, device=dev)
    area_ch = torch.stack([_gather_or_nan(a_flat, a_off + i, a_cnt > i)
                           for i in range(n_channels)], dim=1) if n_channels else \
        torch.zeros((n_events, 0), dtype=torch.float64, device=dev)
    height_ch = torch.stack([_gather_or_nan(h_flat, h_off + i, h_cnt > i)
                             for i in range(n_channels)], dim=1) if n_channels else \
        torch.zeros((n_events, 0), dtype=torch.float64, device=dev)
    has_h, delta_h = has.cpu().numpy(), delta_ps.cpu().numpy()
    return {  # the JAX function's key order
        "area_ch": area_ch.cpu().numpy(),
        "height_ch": height_ch.cpu().numpy(),
        "keep": keep.cpu().numpy(),
        "delta_t": np.where(has_h, delta_h / 1000.0, np.nan),
    }


def group_events_device(
    timestamps: np.ndarray,
    channels: np.ndarray,
    areas: np.ndarray,
    heights: np.ndarray,
    time_window_ns: float,
    presorted: bool = False,
    device: Any = None,
) -> Dict[str, np.ndarray]:
    """Full device grouping pass: sort (optional) -> event ids -> aggregates.

    Returns host arrays: per-hit ``order`` (sort permutation into time order),
    per-hit ``event_id`` (aligned with ``order``), and per-event aggregates
    sliced to ``n_events`` rows. The ragged per-event cell lists (a pandas
    API contract) are assembled on host from ``order``/``event_id``.
    """
    dev = resolve_device(device)
    ts = np.asarray(timestamps, dtype=np.int64)
    n = len(ts)
    if n == 0:
        return {
            "order": np.zeros(0, np.int64),
            "event_id": np.zeros(0, np.int32),
            "n_events": 0,
            "t_min": np.zeros(0, np.int64),
            "t_max": np.zeros(0, np.int64),
            "n_hits": np.zeros(0, np.int32),
        }
    if presorted:
        order = np.arange(n, dtype=np.int64)
        ts_sorted = ts
    else:
        order = np.argsort(ts, kind="stable")
        ts_sorted = ts[order]

    ts_d = _on(ts_sorted, torch.int64, dev)
    eid = anchor_window_event_ids(ts_d, time_window_ns * 1e3, device=dev)
    agg = segment_aggregates(
        eid, ts_d,
        _on(np.asarray(areas, np.float64)[order], torch.float64, dev),
        _on(np.asarray(heights, np.float64)[order], torch.float64, dev),
        num_segments=n,
    )
    eid_host = eid.cpu().numpy()
    n_events = int(eid_host[-1]) + 1
    return {
        "order": order,
        "event_id": eid_host,
        "n_events": n_events,
        **{k: agg[k][:n_events].cpu().numpy()
           for k in ("t_min", "t_max", "n_hits", "area_sum", "height_max")},
    }
