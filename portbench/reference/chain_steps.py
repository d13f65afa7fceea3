"""Plain reference of the chain step, and the comparison that decides
``correct`` for the ``chain_steps`` cells.

``chain_step`` is a frozen copy of the port's ``full_chain_step``
(``models/full_chain.py``) over the frozen plain ops in
``portbench.reference.plain``, with the configuration read from the
cell's configuration file. ``lowp`` rounds the float values of every stage
(the waves as floats, the baselines, the signal, the detection signal and
the outputs) through a lower precision: the benchmark's control runs it
with bfloat16 in the program's place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from portbench.reference import Tally
from portbench.reference.plain.features import feature_reductions
from portbench.reference.plain.hits import threshold_hits_batch
from portbench.reference.plain.peaks import find_peaks_batch, peak_heights_batch
from portbench.reference.plain.widths import width_from_peaks

Round = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t


def chain_step(waves, event_length, baselines, polarity_codes, cfg: dict,
               lowp: Round = None) -> Dict[str, torch.Tensor]:
    """One pass over a padded (n, L) int16 batch: the 12 per-event outputs
    and the 2 overflow counters of ``full_chain_step``."""
    r = lowp or _keep
    n, L = waves.shape
    w32 = r(waves.to(torch.float32))

    hs, he = cfg["height_range"]
    red = feature_reductions(waves, event_length, height_start=hs, height_end=min(he, L),
                             area_start=cfg["area_start"], area_end=L)
    b = r(baselines.to(torch.float32))
    positive = polarity_codes > 0
    has_h = red["count_h"] > 0
    min_h = red["min_h"].to(torch.float32)
    max_h = red["max_h"].to(torch.float32)
    height = torch.where(has_h, torch.where(positive, max_h - b, b - min_h), 0.0)
    amp = torch.where(has_h, max_h - min_h, 0.0)
    count_a = red["count_a"].to(torch.float32)
    sum_a = red["sum_a"].to(torch.float32)
    area = torch.where(positive, sum_a - count_a * b, count_a * b - sum_a)
    area = torch.where(red["count_a"] > 0, area, 0.0)

    sign = torch.where(positive, 1.0, -1.0).to(torch.float32)
    signal = r(sign[:, None] * (w32 - b[:, None]))
    if cfg["use_derivative"]:
        det = r(sign[:, None] * (w32[:, 1:] - w32[:, :-1]))
        det_len = (event_length - 1).clamp(min=0)
    else:
        det = signal
        det_len = event_length
    peaks = find_peaks_batch(det, height=cfg["peak_height"], prominence=cfg["peak_prominence"],
                             width=cfg["peak_width"], distance=cfg["peak_distance"],
                             max_peaks=cfg["max_peaks"], valid_length=det_len.to(torch.int32))
    peak_heights = peak_heights_batch(w32, peaks["left_ips"], peaks["right_ips"], peaks["valid"])

    hits = threshold_hits_batch(
        signal, torch.full((n,), cfg["hit_threshold"], dtype=torch.float32, device=waves.device),
        event_length.to(torch.int32), left_extension=cfg["left_extension"],
        right_extension=cfg["right_extension"], max_hits=cfg["max_hits"])

    best_k = torch.where(peaks["valid"], peak_heights, float("-inf")).argmax(dim=1)
    best_pos = torch.gather(peaks["position"], 1, best_k[:, None])[:, 0]
    has_peak = peaks["valid"].any(dim=1)
    widths = width_from_peaks(signal, torch.where(has_peak, best_pos, 0),
                              rise_low=cfg["rise_low"], rise_high=cfg["rise_high"],
                              fall_high=cfg["rise_high"], fall_low=cfg["rise_low"])
    width_samples = torch.where(has_peak & widths["valid"], widths["total_samples"], 0.0)

    classified = has_peak & (width_samples > 0)
    label = torch.where(
        classified & (width_samples <= cfg["s1_width_max"]), 1,
        torch.where(classified & (width_samples >= cfg["s2_width_min"]), 2, 0),
    ).to(torch.int8)
    return {
        "height": r(height), "amp": r(amp), "area": r(area),
        "max_abs_diff": r(red["max_abs_diff"].to(torch.float32)),
        "peak_position": torch.where(has_peak, best_pos, -1).to(torch.int32),
        "n_peaks": peaks["valid"].sum(dim=1, dtype=torch.int32),
        "n_hits": hits["valid"].sum(dim=1, dtype=torch.int32),
        "hit_integral": r(torch.where(hits["valid"], hits["integral"], 0.0).sum(dim=1)),
        "rise_samples": r(torch.where(has_peak, widths["rise_samples"], 0.0)),
        "fall_samples": r(torch.where(has_peak, widths["fall_samples"], 0.0)),
        "width_samples": r(width_samples),
        "label": label,
        "n_peak_overflow": (peaks["n_candidates"] > cfg["max_peaks"]).sum(dtype=torch.int32),
        "n_hit_overflow": (hits["n_runs"] > cfg["max_hits"]).sum(dtype=torch.int32),
    }


def reference(inputs: dict, config: dict, workload: dict, device, lowp: Round = None) -> dict:
    """The plain chain's outputs for every batch a kept step read, on the host."""
    out = {}
    for b, batch in inputs["batches"].items():
        with torch.no_grad():
            res = chain_step(*(t.to(device) for t in batch), inputs["chain"], lowp)
        out[b] = {k: v.cpu() for k, v in res.items()}
    return out


def control(inputs: dict, config: dict, workload: dict, device) -> list:
    """The reference in bfloat16, in the place of the program's answers."""
    low = reference(inputs, config, workload, device, lowp=bfloat16)
    return [(b, low[b]) for b in sorted(low)]


def bfloat16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def compare(expected: dict, answers: list) -> dict:
    """The kept steps' outputs against the plain chain's (see ``Tally``)."""
    tally = Tally()
    for i, (b, out) in enumerate(answers):
        tally.columns({k: v.numpy() for k, v in expected[b].items()},
                      {k: v.numpy() for k, v in out.items()}, f"step {i} (batch {b})")
    return tally.result()
