"""Peak detection: scipy.signal.find_peaks parity over a batch.

Port of ``waveformanalysis_tpu/ops/peaks.py`` (``compact_first_k``,
``find_peaks_batch``, ``peak_heights_batch``). The pipeline is the same:
plateau-aware local maxima from a packed cummax of the last nonzero
difference, the height (and optional neighbour-threshold) filter,
compaction of the first K candidates by position, greedy distance pruning
by height priority, prominence with full-window bases, and rel_height
interpolated left/right ips. Ties in the distance pruning resolve like the
JAX package: of two equal heights the later position wins.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

DEFAULT_MAX_PEAKS = 32

_NEG = -3.0e38  # sentinel below any float32 signal


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[row, idx[row]] for each row (take_along_axis on axis 1)."""
    return torch.gather(a, 1, idx.long()[:, None])[:, 0]


def compact_first_k(
    flags: torch.Tensor,
    arrays: Tuple[torch.Tensor, ...],
    K: int,
    fills: Tuple[Any, ...],
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Compact the first K flagged columns (in positional order) of each
    (n, L) array into (n, K). Returns (compacted_arrays, ok_mask)."""
    n = flags.shape[0]
    dev = flags.device
    rank = torch.cumsum(flags.to(torch.int32), dim=1, dtype=torch.int32)
    outs = [torch.full((n, K), f, dtype=a.dtype, device=dev)
            for a, f in zip(arrays, fills)]
    ok_all = torch.zeros((n, K), dtype=torch.bool, device=dev)
    # rows never have more than max(rank) flagged columns: loop only that far
    kmax = min(K, int(rank[:, -1].max())) if rank.numel() else 0
    for k in range(kmax):
        hit = flags & (rank == (k + 1))  # at most one True per row
        idx = hit.to(torch.uint8).argmax(dim=1)
        ok = hit.any(dim=1)
        for o, a, f in zip(outs, arrays, fills):
            o[:, k] = torch.where(ok, _take(a, idx), f)
        ok_all[:, k] = ok
    return tuple(outs), ok_all


def find_peaks_batch(
    signal: torch.Tensor,
    height: float,
    prominence: float,
    width: float,
    distance: int = 1,
    max_peaks: int = DEFAULT_MAX_PEAKS,
    rel_height: float = 0.5,
    valid_length: Optional[torch.Tensor] = None,
    threshold: Optional[Tuple[Optional[float], Optional[float]]] = None,
) -> Dict[str, torch.Tensor]:
    """find_peaks over a (n, L) batch.

    Returns dict of (n, K) tensors: position (int32, -1 invalid), valid
    (bool), peak_value, prominence, left_ips, right_ips, widths, left_bases,
    right_bases; plus n_candidates (n,) int32 for overflow accounting.
    """
    x = signal.to(torch.float32)
    n, L = x.shape
    K = max_peaks
    dev = x.device
    f32, i32 = torch.float32, torch.int32
    pos_row = torch.arange(L, device=dev, dtype=i32)[None, :]

    if valid_length is None:
        vlen = torch.full((n,), L, dtype=i32, device=dev)
    else:
        vlen = valid_length.to(i32)
    in_range = pos_row < vlen[:, None]
    x = torch.where(in_range, x, _NEG)

    # ---- local maxima with plateau midpoints --------------------------------
    # the last nonzero diff's index and direction pack into idx*2 + rise,
    # carried by one cummax; the plateau value is the right-edge sample
    d = x[:, 1:] - x[:, :-1]  # (n, L-1)
    didx = pos_row[:, : L - 1]
    packed = torch.where(d != 0, didx * 2 + (d > 0).to(i32), -1)
    prev_ff = torch.cat(
        [torch.full((n, 1), -1, dtype=i32, device=dev),
         torch.cummax(packed, dim=1).values[:, :-1]],
        dim=1,
    )
    prev_was_rise = (prev_ff >= 0) & (prev_ff % 2 == 1)
    right_edge_mask = (d < 0) & prev_was_rise
    left_edge = torch.where(prev_ff >= 0, prev_ff // 2 + 1, 0)
    midpoint = (left_edge + didx) // 2  # operands >= 0: floor == trunc

    is_peak = right_edge_mask
    # no peak at the first/last sample of the true wave, and the falling
    # edge must lie inside it (d[i] reads sample i+1)
    is_peak = is_peak & (midpoint <= (vlen[:, None] - 2)) & (midpoint >= 1)
    is_peak = is_peak & (didx <= (vlen[:, None] - 2))
    peak_value = x[:, : L - 1]
    is_peak = is_peak & (peak_value >= height)

    if threshold is not None:
        # scipy neighbour-threshold condition at the plateau midpoint m:
        # width-1 peaks see (d[i-1], -d[i]), width-2 plateaus (d[i-2], 0),
        # wider plateaus (0, 0)
        tmin, tmax = threshold
        plateau_w = didx - left_edge + 1
        zcol = torch.zeros((n, 1), dtype=x.dtype, device=dev)
        d_prev = torch.cat([zcol, d[:, :-1]], dim=1)
        d_prev2 = torch.cat([zcol, zcol, d[:, :-2]], dim=1)
        left_thr = torch.where(plateau_w == 1, d_prev,
                               torch.where(plateau_w == 2, d_prev2, 0.0))
        right_thr = torch.where(plateau_w == 1, -d, 0.0)
        if tmin is not None:
            is_peak = is_peak & (torch.minimum(left_thr, right_thr) >= tmin)
        if tmax is not None:
            is_peak = is_peak & (torch.maximum(left_thr, right_thr) <= tmax)

    n_candidates = is_peak.sum(dim=1, dtype=i32)

    # ---- compact to (n, K) by position --------------------------------------
    (positions, values), cand_valid = compact_first_k(
        is_peak, (midpoint, peak_value), K, (-1, _NEG)
    )

    # ---- distance filter: greedy by height priority -------------------------
    n_compacted = cand_valid.sum(dim=1, dtype=i32)
    kmax = min(K, int(n_compacted.max())) if n else 0
    if distance > 1:
        # priority: higher value first; ties -> later slot first
        kk = torch.arange(K, device=dev)
        v_i = values[:, :, None]
        v_j = values[:, None, :]
        beats_i = (v_j > v_i) | ((v_j == v_i) & (kk[None, None, :] > kk[None, :, None]))
        prio_rank = beats_i.sum(dim=2, dtype=i32)  # (n, K): 0 = first
        keep = cand_valid.clone()
        for k in range(kmax):
            sel = (prio_rank == k).to(torch.uint8).argmax(dim=1)
            p = _take(positions, sel)
            v = _take(cand_valid, sel)
            kept_k = _take(keep, sel)
            close = (positions - p[:, None]).abs() < distance
            suppress = close & (kk[None, :] != sel[:, None]) & (kept_k & v)[:, None]
            keep = keep & ~suppress
        cand_valid = cand_valid & keep
        positions = torch.where(cand_valid, positions, -1)
        values = torch.where(cand_valid, values, _NEG)

    # ---- prominence + bases (wlen = full window) + rel-height ips -----------
    prominences = torch.zeros((n, K), dtype=f32, device=dev)
    left_bases = torch.zeros((n, K), dtype=i32, device=dev)
    right_bases = torch.zeros((n, K), dtype=i32, device=dev)
    left_ips = torch.zeros((n, K), dtype=f32, device=dev)
    right_ips = torch.zeros((n, K), dtype=f32, device=dev)
    inf = float("inf")

    for k in range(kmax):
        p = positions[:, k]
        v = values[:, k]
        ok = cand_valid[:, k]
        pc = p[:, None]

        higher = x > v[:, None]
        prev_higher = torch.where(higher & (pos_row < pc), pos_row, -1).amax(dim=1)
        lmask = (pos_row >= (prev_higher + 1)[:, None]) & (pos_row <= pc) & in_range
        left_min = torch.where(lmask, x, inf).amin(dim=1)
        # scipy walks leftward on strict '<': ties go to the rightmost minimum
        lbase = torch.where(lmask & (x == left_min[:, None]), pos_row, -1).amax(dim=1)
        lbase = lbase.clamp(min=0)

        next_higher = torch.where(higher & (pos_row > pc), pos_row, L).amin(dim=1)
        rmask = (pos_row >= pc) & (pos_row <= (next_higher - 1)[:, None]) & in_range
        rvals = torch.where(rmask, x, inf)
        right_min = rvals.amin(dim=1)
        # rightward on strict '<': ties go to the leftmost minimum
        rbase = rvals.argmin(dim=1).to(i32)

        prom = torch.where(ok, v - torch.maximum(left_min, right_min), 0.0)

        h_eval = v - prom * rel_height
        hc = h_eval[:, None]
        below_l = (x <= hc) & (pos_row >= lbase[:, None]) & (pos_row <= pc) & in_range
        jl = torch.where(below_l, pos_row, -1).amax(dim=1)
        jl_safe = jl.clamp(0, L - 2)
        xl = _take(x, jl_safe)
        xl1 = _take(x, jl_safe + 1)
        lip = torch.where(
            jl >= 0,
            torch.where(xl < h_eval,
                        jl + (h_eval - xl) / torch.where(xl1 != xl, xl1 - xl, 1.0),
                        jl.to(f32)),
            lbase.to(f32),
        )
        below_r = (x <= hc) & (pos_row <= rbase[:, None]) & (pos_row >= pc) & in_range
        jr = torch.where(below_r, pos_row, L).amin(dim=1)
        jr_safe = jr.clamp(1, L - 1)
        xr = _take(x, jr_safe)
        xr_1 = _take(x, jr_safe - 1)
        rip = torch.where(
            jr < L,
            torch.where(xr < h_eval,
                        jr - (h_eval - xr) / torch.where(xr_1 != xr, xr_1 - xr, 1.0),
                        jr.to(f32)),
            rbase.to(f32),
        )

        prominences[:, k] = torch.where(ok, prom, prominences[:, k])
        left_bases[:, k] = torch.where(ok, lbase, left_bases[:, k])
        right_bases[:, k] = torch.where(ok, rbase, right_bases[:, k])
        left_ips[:, k] = torch.where(ok, lip, left_ips[:, k])
        right_ips[:, k] = torch.where(ok, rip, right_ips[:, k])

    widths = right_ips - left_ips
    final_valid = cand_valid & (prominences >= prominence) & (widths >= width)
    positions = torch.where(final_valid, positions, -1)

    return {
        "position": positions.to(i32),
        "valid": final_valid,
        "peak_value": values,
        "prominence": prominences,
        "left_ips": left_ips,
        "right_ips": right_ips,
        "widths": widths,
        "left_bases": left_bases,
        "right_bases": right_bases,
        "n_candidates": n_candidates,
    }


def peak_heights_batch(
    waves: torch.Tensor,
    left_ips: torch.Tensor,
    right_ips: torch.Tensor,
    valid: torch.Tensor,
    method: str = "minmax",
    window_extension: int = 4,
) -> torch.Tensor:
    """Per-peak height from the original waveform.

    minmax: max-min over [round(l)-ext, round(r)+ext);
    diff: sum of -diff(wave) over [round(l), round(r)).
    """
    n, L = waves.shape
    K = left_ips.shape[1]
    w = waves.to(torch.float32)
    pos = torch.arange(L, device=w.device, dtype=torch.int32)[None, :]
    # torch.round rounds half to even, like jnp.round
    start = torch.round(left_ips).to(torch.int32).clamp(0, L - 1)
    end = torch.round(right_ips).to(torch.int32).clamp(0, L - 1)
    out = torch.zeros((n, K), dtype=torch.float32, device=w.device)
    inf = float("inf")
    for k in range(K):
        s = start[:, k][:, None]
        e = end[:, k][:, None]
        if method == "minmax":
            m = (pos >= (s - window_extension).clamp(min=0)) & (
                pos < (e + window_extension).clamp(max=L))
            mx = torch.where(m, w, -inf).amax(dim=1)
            mn = torch.where(m, w, inf).amin(dim=1)
            h = torch.where(m.any(dim=1), mx - mn, 0.0)
        else:  # diff
            d = -(w[:, 1:] - w[:, :-1])
            dpos = pos[:, : L - 1]
            h = torch.where((dpos >= s) & (dpos < e), d, 0.0).sum(dim=1)
        out[:, k] = torch.where(valid[:, k], h, 0.0)
    return out
