"""Plain reference of the ``v1725_runs`` cells; the comparison is
``file_runs``'.

``reference`` works out every table that the cell compares from the arrays
the benchmark wrote into the run's DAW_DEMO files (each record's channel,
length, sample-index timestamp and samples in file order, the header
baseline, and the first file's epoch), never from the program's parse,
with the settings of the cell's configuration file:

- ``records``: the records in one stable sort on (timestamp, pid, board,
  channel, input order), every record of board 0 and pid 0; the timestamp
  the sample index times ``dt_ns`` in ps; the baseline the header's;
  polarity negative (the configuration's channel default); the record id
  the row, ``wave_offset`` the running sum of the lengths before it and
  ``time`` the file epoch plus the timestamp in ns;
- ``wave_pool``: the uint16 samples in that order; ``wave_pool_filtered``
  the plain Savitzky-Golay filter of each record at its true length;
- per record, at its true length: basic_features, hit (find_peaks on the
  filtered pool less the baseline, times the polarity's sign),
  hit_threshold and the integral widths (on the raw samples less the
  baseline, times the sign), with the frozen plain ops of
  ``portbench.reference.plain``;
- the event layer through ``plain/events.py``, as ``records_runs`` builds it.

The records of one length are computed together on the given device and
put back in record order (``records_runs.by_length``, ``put_back``).
``lowp`` rounds the float values of every stage and the float columns of
every table through a lower precision (the benchmark's control runs it
with bfloat16).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from portbench.reference.file_runs import (
    HIT_MERGED_FIELDS,
    Round,
    _keep,
    _round_tables,
    _slots,
    bfloat16,
    compare,
)
from portbench.reference.plain import events
from portbench.reference.plain.features import _norm_window, combine_features, feature_reductions
from portbench.reference.plain.filtering import savgol
from portbench.reference.plain.hits import threshold_columns_from_flat, threshold_hits_batch
from portbench.reference.plain.integral_width import integral_quantile_width
from portbench.reference.plain.peaks import (
    find_peaks_batch,
    hit_columns_from_flat,
    peak_heights_batch,
)
from portbench.reference.records_runs import by_length, put_back

__all__ = ["reference", "control", "compare"]

POLARITY = {"positive": 1, "negative": -1}


def records(inputs: dict, config: dict) -> tuple:
    """(records columns, wave_pool) of the run."""
    fmt = config["format"]
    channel = np.asarray(inputs["channel"], np.int16)
    length = np.asarray(inputs["length"], np.int32)
    n = len(channel)
    ts = np.asarray(inputs["sample_index"], np.int64) * int(fmt["dt_ns"]) * 1000
    board = np.zeros(n, np.int16)
    pid = np.zeros(n, np.int32)
    order = np.lexsort((np.arange(n), channel, board, pid, ts))  # the last key leads
    written_at = np.concatenate([[0], np.cumsum(length, dtype=np.int64)[:-1]])
    ts, channel, length, source = ts[order], channel[order], length[order], written_at[order]
    offset = np.concatenate([[0], np.cumsum(length, dtype=np.int64)[:-1]]).astype(np.int64)
    samples = np.asarray(inputs["pool"], np.int16)
    pool = samples[np.repeat(source - offset, length) + np.arange(int(length.sum()))]
    pol = POLARITY[config["context"]["channel_metadata"]["defaults"]["polarity"]]
    cols = {"timestamp": ts, "pid": pid, "board": board, "channel": channel,
            "baseline": np.full(n, float(inputs["baseline"])),
            "baseline_upstream": np.full(n, np.nan),
            "polarity": np.full(n, pol, np.int8), "record_id": np.arange(n, dtype=np.int64),
            "dt": np.full(n, int(fmt["dt_ns"]), np.int32),
            "trigger_type": np.zeros(n, np.int16), "flags": np.zeros(n, np.uint32),
            "wave_offset": offset, "event_length": length,
            "time": int(inputs["epoch_ns"]) + ts // 1000}
    return cols, pool.astype(np.uint16)


def reference(inputs: dict, config: dict, workload: dict, device,
              lowp: Round = None) -> Dict[str, object]:
    import pandas as pd

    r: Callable = lowp or _keep
    P = config["plugins"]
    rec, pool = records(inputs, config)
    n = len(rec["timestamp"])
    ts, board, channel, rid = rec["timestamp"], rec["board"], rec["channel"], rec["record_id"]
    dt, lengths, baseline = rec["dt"], rec["event_length"], rec["baseline"]
    sign_all = np.where(rec["polarity"] > 0, 1.0, -1.0).astype(np.float32)
    out: Dict[str, object] = {"records": rec, "wave_pool": {"wave_pool": pool}}

    fw, bf, hp, tp = (P[k] for k in ("wave_pool_filtered", "basic_features", "hit",
                                     "hit_threshold"))
    wi = P["waveform_width_integral"]
    filtered_pool = np.zeros(len(pool), np.float32)
    feats, peaks, heights, runs, widths = [], [], [], [], []
    for L, rows in by_length(lengths):
        idx = rec["wave_offset"][rows][:, None] + np.arange(L)[None, :]
        W = torch.from_numpy(pool[idx].astype(np.int16)).to(device)
        el = torch.full((len(rows),), L, dtype=torch.int32, device=device)
        b32 = r(torch.from_numpy(baseline[rows].astype(np.float32)).to(device))
        sign = torch.from_numpy(sign_all[rows]).to(device)[:, None]
        raw = r(W.to(torch.float32))
        filtered = r(savgol(W, fw["sg_window_size"], fw["sg_poly_order"]))
        filtered_pool[idx.reshape(-1)] = filtered.cpu().numpy().reshape(-1)

        hs, he = _norm_window(bf["height_range"][0], bf["height_range"][1], L)
        as_, ae = _norm_window(bf["area_range"][0], bf["area_range"][1], L)
        feats.append((rows, feature_reductions(W, el, height_start=hs, height_end=he,
                                               area_start=as_, area_end=ae)))

        source = filtered if hp["use_filtered"] else raw
        det = r(sign * (source - b32[:, None]))
        pk = find_peaks_batch(det, height=hp["height"], prominence=hp["prominence"],
                              width=hp["width"], distance=hp["distance"],
                              max_peaks=hp["max_peaks_per_waveform"], valid_length=el)
        peaks.append((rows, pk))
        heights.append((rows, {"h": r(peak_heights_batch(
            source, pk["left_ips"], pk["right_ips"], pk["valid"], method=hp["height_method"],
            window_extension=hp["height_window_extension"]))}))

        signal = r(sign * (raw - b32[:, None]))
        th = threshold_hits_batch(signal, torch.full((len(rows),), float(tp["threshold"]),
                                                     device=device),
                                  el, left_extension=tp["left_extension"],
                                  right_extension=tp["right_extension"],
                                  max_hits=tp["max_hits_per_waveform"])
        runs.append((rows, {k: r(v) if v.dtype.is_floating_point else v
                            for k, v in th.items()}))
        widths.append((rows, {k: r(v) for k, v in integral_quantile_width(
            signal, q_low=wi["q_low"], q_high=wi["q_high"]).items()}))
    out["wave_pool_filtered"] = {"wave_pool_filtered": filtered_pool}

    red = put_back(n, feats)
    f = combine_features(red, baseline, rec["polarity"])
    out["basic_features"] = dict(f, timestamp=ts, board=board, channel=channel,
                                 event_index=rid)

    pk, h = put_back(n, peaks), put_back(n, heights)["h"]
    v = pk["valid"]
    rows_, cols_ = np.nonzero(v)
    hit = hit_columns_from_flat(rows=rows_, position=pk["position"][rows_, cols_],
                                heights=h[rows_, cols_], left_ips=pk["left_ips"][rows_, cols_],
                                right_ips=pk["right_ips"][rows_, cols_], timestamps=ts,
                                boards=board, channels=channel, record_ids=rid, dt_ns=dt)
    out["hit"] = hit

    th = put_back(n, runs)
    rows_, s = _slots(torch.from_numpy(th["valid"]), {
        k: torch.from_numpy(th[k]) for k in ("position", "height", "integral", "seg_start",
                                            "seg_end", "run_start", "run_end")})
    threshold = threshold_columns_from_flat(rows=rows_, timestamps=ts, boards=board,
                                            channels=channel, record_ids=rid, dt_ns=dt,
                                            record_lengths=lengths, **s)
    out["hit_threshold"] = threshold

    wd = put_back(n, widths)
    step = 1.0 / float(wi["sampling_rate"])
    out["waveform_width_integral"] = {
        "t_low": (wd["t_low_samples"] * step).astype(np.float32),
        "t_high": (wd["t_high_samples"] * step).astype(np.float32),
        "width": (wd["width_samples"] * step).astype(np.float32),
        "t_low_samples": wd["t_low_samples"].astype(np.float32),
        "t_high_samples": wd["t_high_samples"].astype(np.float32),
        "width_samples": wd["width_samples"].astype(np.float32),
        "q_total": wd["q_total"].astype(np.float64),
        "timestamp": ts, "board": board, "channel": channel,
        "event_index": np.arange(n, dtype=np.int64)}

    mp = P["hit_merge_clusters"]
    merged, components = events.merge_hits(threshold, float(mp["merge_gap_ns"]),
                                           float(mp["max_total_width_ns"]))
    out["hit_merged"] = {k: merged[k] for k in HIT_MERGED_FIELDS}
    out["hit_merged_components"] = {"merged_index": components[:, 0],
                                    "hit_index": components[:, 1]}

    f = out["basic_features"]
    df = pd.DataFrame({"timestamp": ts, "board": board, "channel": channel,
                       "height": f["height"], "amp": f["amp"], "area": f["area"],
                       "max_abs_diff": f["max_abs_diff"], "event_index": rid})
    df["record_id"] = rid
    out["df"] = df
    out["df_events"] = events.df_events(df, float(P["df_events"]["time_window_ns"]))
    out["hit_grouped"] = events.hit_grouped(out["hit_merged"],
                                            float(P["hit_grouped"]["time_window_ns"]),
                                            components, threshold)
    out["df_paired"] = events.df_paired(out["df_events"], float(P["df_paired"]["time_window_ns"]),
                                        int(config["context"]["n_channels"]),
                                        int(config["context"]["start_channel_slice"]))
    if lowp is not None:
        _round_tables(out, r)
    return {k: out[k] for k in workload["compared"]}


def control(inputs: dict, config: dict, workload: dict, device) -> list:
    """The reference in bfloat16, in the place of the program's answers."""
    return [("control", reference(inputs, config, workload, device, lowp=bfloat16))]
