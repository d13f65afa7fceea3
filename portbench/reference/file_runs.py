"""Plain reference of the ``file_runs`` cells, and their comparison.

``reference`` works out every table that the cell compares from the arrays
the benchmark wrote into the run's files (never from the program's parse),
with the settings of the cell's configuration file: st_waveforms (the
baseline the float64 mean of the format's baseline window), the
Savitzky-Golay filtered waves, basic_features, hit (find_peaks on the
filtered waves less the baseline), hit_threshold, waveform_width (at each
hit's peak on the raw waves), s1_s2, hit_merged and its components, df,
df_events, hit_grouped and df_paired. The per-event arithmetic runs on the
given device with the frozen plain ops of ``portbench.reference.plain``;
the joins run on the host, and the event layer there as loops written from
the tables' definitions (``plain/events.py``), not from the program's code. ``lowp`` rounds the float
values of every stage and the float columns of every table through a lower
precision (the benchmark's control runs it with bfloat16).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from portbench.reference import Tally
from portbench.reference.plain.features import _norm_window, combine_features, feature_reductions
from portbench.reference.plain.filtering import savgol
from portbench.reference.plain import events
from portbench.reference.plain.hits import threshold_columns_from_flat, threshold_hits_batch
from portbench.reference.plain.peaks import (
    find_peaks_batch,
    hit_columns_from_flat,
    peak_heights_batch,
)
from portbench.reference.plain.widths import width_from_peaks

Round = Optional[Callable[[torch.Tensor], torch.Tensor]]

HIT_MERGED_FIELDS = ("position", "height", "integral", "sample_start", "sample_end", "width",
                     "dt", "rise_time", "fall_time", "timestamp", "board", "channel",
                     "record_id", "component_offset", "component_count")


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t


def bfloat16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _slots(valid: torch.Tensor, fields: Dict[str, torch.Tensor]):
    """(rows, {name: values}) of the valid slots of (n, K) tables, in
    row-major order, on the host."""
    v = valid.cpu().numpy()
    rows, cols = np.nonzero(v)
    return rows, {k: t.cpu().numpy()[rows, cols] for k, t in fields.items()}


def _in_range(values: np.ndarray, bounds) -> np.ndarray:
    ok = ~np.isnan(values)
    lo, hi = bounds
    if lo is not None:
        ok &= values >= lo
    if hi is not None:
        ok &= values <= hi
    return ok


def classify(widths: dict, features: dict, cfg: dict) -> dict:
    """s1_s2: S1 where the width (ns or samples) lies in the S1 range and
    not the S2 range, S2 the other way round, 0 otherwise; height and area
    joined from basic_features by record id (the event index here)."""
    n = len(widths["record_id"])
    width_ns = widths["total_width"].astype(np.float64)
    width_samples = widths["total_width_samples"].astype(np.float64)
    rid = widths["record_id"]
    height = features["height"].astype(np.float64)[rid]
    area = features["area"].astype(np.float64)[rid]
    value = width_samples if cfg["width_unit"] == "samples" else width_ns
    s1 = _in_range(value, cfg["s1_width_range"])
    s2 = _in_range(value, cfg["s2_width_range"])
    label = np.zeros(n, dtype=np.int8)
    label[s1 & ~s2] = 1
    label[s2 & ~s1] = 2
    return {"label": label, "width_ns": width_ns.astype(np.float32),
            "width_samples": width_samples.astype(np.float32),
            "height": height.astype(np.float32), "area": area.astype(np.float32),
            "timestamp": widths["timestamp"], "board": widths["board"],
            "channel": widths["channel"], "record_id": rid,
            "peak_position": widths["peak_position"]}


def reference(inputs: dict, config: dict, workload: dict, device,
              lowp: Round = None) -> Dict[str, object]:
    import pandas as pd

    r = lowp or _keep
    fmt, P = config["format"], config["plugins"]
    waves = np.asarray(inputs["wave"], np.int16)
    n, L = waves.shape
    ts = np.asarray(inputs["timestamp"], np.int64)
    channel = np.asarray(inputs["channel"], np.int16)
    board = np.zeros(n, np.int16)
    record_id = np.arange(n, dtype=np.int64)
    dt = np.full(n, int(fmt["dt_ns"]), np.int32)
    b0, b1 = fmt["baseline_window"]
    baseline = np.mean(waves[:, b0:b1].astype(np.float64), axis=1)
    polarity = np.ones(n, np.int8)  # positive on every channel
    st = {"baseline": baseline, "baseline_upstream": np.full(n, np.nan),
          "polarity": polarity, "timestamp": ts, "record_id": record_id, "dt": dt,
          "event_length": np.full(n, L, np.int32), "board": board, "channel": channel,
          "wave": waves}
    out: Dict[str, object] = {"st_waveforms": st}

    W = torch.from_numpy(waves).to(device)
    el = torch.full((n,), L, dtype=torch.int32, device=device)
    sign = torch.where(torch.from_numpy(polarity).to(device) > 0, 1.0, -1.0)
    b32 = r(torch.from_numpy(baseline.astype(np.float32)).to(device))
    fw = P["filtered_waveforms"]
    filtered = r(savgol(W, fw["sg_window_size"], fw["sg_poly_order"]))

    bf = P["basic_features"]
    hs, he = _norm_window(bf["height_range"][0], bf["height_range"][1], L)
    as_, ae = _norm_window(bf["area_range"][0], bf["area_range"][1], L)
    red = feature_reductions(W, el, height_start=hs, height_end=he, area_start=as_, area_end=ae)
    feats = combine_features({k: v.cpu().numpy() for k, v in red.items()}, baseline, polarity)
    out["basic_features"] = dict(feats, timestamp=ts, board=board, channel=channel,
                                 event_index=record_id)

    hp = P["hit"]
    source = filtered if hp["use_filtered"] else r(W.to(torch.float32))
    det = r(sign[:, None] * (source - b32[:, None]))
    peaks = find_peaks_batch(det, height=hp["height"], prominence=hp["prominence"],
                             width=hp["width"], distance=hp["distance"],
                             max_peaks=hp["max_peaks_per_waveform"], valid_length=el)
    heights = r(peak_heights_batch(source, peaks["left_ips"], peaks["right_ips"], peaks["valid"],
                                   method=hp["height_method"],
                                   window_extension=hp["height_window_extension"]))
    rows, s = _slots(peaks["valid"], {"position": peaks["position"], "heights": heights,
                                      "left_ips": r(peaks["left_ips"]),
                                      "right_ips": r(peaks["right_ips"])})
    hit = hit_columns_from_flat(rows=rows, timestamps=ts, boards=board, channels=channel,
                                record_ids=record_id, dt_ns=dt, **s)
    out["hit"] = hit

    tp = P["hit_threshold"]
    signal = r(sign[:, None] * (W.to(torch.float32) - b32[:, None]))
    runs = threshold_hits_batch(signal, torch.full((n,), float(tp["threshold"]), device=device),
                                el, left_extension=tp["left_extension"],
                                right_extension=tp["right_extension"],
                                max_hits=tp["max_hits_per_waveform"])
    rows, s = _slots(runs["valid"], {
        k: r(runs[k]) if runs[k].dtype.is_floating_point else runs[k]
        for k in ("position", "height", "integral", "seg_start", "seg_end", "run_start",
                  "run_end")})
    threshold = threshold_columns_from_flat(rows=rows, timestamps=ts, boards=board,
                                            channels=channel, record_ids=record_id, dt_ns=dt,
                                            record_lengths=np.full(n, L, np.int64), **s)
    out["hit_threshold"] = threshold

    wp = P["waveform_width"]
    rid = hit["record_id"]
    pos = hit["position"]
    wsource = filtered if wp["use_filtered"] else r(W.to(torch.float32))
    wd = width_from_peaks(wsource[torch.from_numpy(rid).to(device)],
                          torch.from_numpy(pos.astype(np.int32)).to(device),
                          rise_low=wp["rise_low"], rise_high=wp["rise_high"],
                          fall_high=wp["fall_high"], fall_low=wp["fall_low"],
                          interpolation=wp["interpolation"])
    wd = {k: r(v).cpu().numpy() if v.dtype.is_floating_point else v.cpu().numpy()
          for k, v in wd.items()}
    keep = np.flatnonzero(wd["valid"])
    rate = float(wp["sampling_rate"])
    rs, fs, tw = (wd[k][keep] for k in ("rise_samples", "fall_samples", "total_samples"))
    widths = {"rise_time": (rs / rate).astype(np.float32),
              "fall_time": (fs / rate).astype(np.float32),
              "total_width": (tw / rate).astype(np.float32),
              "rise_time_samples": rs.astype(np.float32),
              "fall_time_samples": fs.astype(np.float32),
              "total_width_samples": tw.astype(np.float32),
              "peak_position": pos[keep],
              "peak_height": wd["peak_height"][keep].astype(np.float32),
              "timestamp": hit["timestamp"][keep], "board": hit["board"][keep],
              "channel": hit["channel"][keep], "record_id": rid[keep]}
    out["waveform_width"] = widths
    sp = P["s1_s2"]
    out["s1_s2"] = classify(widths, out["basic_features"], {
        "width_unit": sp["width_unit"], "s1_width_range": sp["s1_width_range"],
        "s2_width_range": sp["s2_width_range"]})

    mp = P["hit_merge_clusters"]
    merged, components = events.merge_hits(threshold, float(mp["merge_gap_ns"]),
                                           float(mp["max_total_width_ns"]))
    out["hit_merged"] = {k: merged[k] for k in HIT_MERGED_FIELDS}
    out["hit_merged_components"] = {"merged_index": components[:, 0],
                                    "hit_index": components[:, 1]}

    f = out["basic_features"]
    df = pd.DataFrame({"timestamp": ts, "board": board, "channel": channel,
                       "height": f["height"], "amp": f["amp"], "area": f["area"],
                       "max_abs_diff": f["max_abs_diff"], "event_index": record_id})
    df["record_id"] = df["event_index"]
    out["df"] = df
    tw_ns = float(P["df_events"]["time_window_ns"])
    out["df_events"] = events.df_events(df, tw_ns)
    out["hit_grouped"] = events.hit_grouped(out["hit_merged"],
                                            float(P["hit_grouped"]["time_window_ns"]),
                                            components, threshold)
    out["df_paired"] = events.df_paired(out["df_events"], float(P["df_paired"]["time_window_ns"]),
                                        int(config["context"]["n_channels"]),
                                        int(config["context"]["start_channel_slice"]))
    if lowp is not None:
        _round_tables(out, r)
    return {k: out[k] for k in workload["compared"]}


def _round_tables(tables: dict, r) -> None:
    """Round every float32 column (and per-event float32 cell) through ``r``."""
    def rounded(a: np.ndarray) -> np.ndarray:
        return r(torch.from_numpy(np.array(a, copy=True))).numpy()

    for name, t in tables.items():
        if isinstance(t, dict):
            for k, v in t.items():
                if isinstance(v, np.ndarray) and v.dtype == np.float32:
                    t[k] = rounded(v)
        else:
            for col in t.columns:
                if t[col].dtype == np.float32:
                    t[col] = rounded(t[col].to_numpy())
                elif t[col].dtype == object and len(t) and \
                        np.asarray(t[col].iloc[0]).dtype == np.float32:
                    t[col] = [rounded(np.asarray(c)) for c in t[col]]


def control(inputs: dict, config: dict, workload: dict, device) -> list:
    """The reference in bfloat16, in the place of the program's answers."""
    return [("control", reference(inputs, config, workload, device, lowp=bfloat16))]


def compare(expected: dict, answers: list) -> dict:
    """Each compared table of each read-back run against the reference
    (see ``Tally``); a table missing from a run counts as structure."""
    tally = Tally()
    for run, tables in answers:
        for name, ref in expected.items():
            got = tables.get(name)
            where = f"{run}/{name}"
            if got is None:
                tally.count("structure", 1, f"{where}: missing")
            elif isinstance(ref, dict):
                tally.columns(ref, got, where)
            else:
                tally.frame(ref, got, where)
    if not answers:
        tally.count("structure", 1, "no run finished")
    return tally.result()
