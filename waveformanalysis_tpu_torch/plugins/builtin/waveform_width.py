"""waveform_width plugin: per-hit 10%->90% rise/fall times.

Behavioral analog of the reference WaveformWidthPlugin
(reference: waveform_analysis/core/plugins/builtin/cpu/waveform_width.py:40):
for each detected hit, baseline = mean of the first 50 samples of its
waveform, thresholds are fractions of the corrected peak value, crossings
interpolate linearly, times divide by the sampling rate (GHz -> ns). Hits
whose corrected peak value <= 0 are skipped (positive-going convention).

The reference's per-hit Python loop becomes one vectorized gather (one row
per hit) + one device call; inside the fused bundle the width scan kernel
(ops/width_scan_cuda.py) reads the hit stage's peak slots on the device.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import scan_backend, to_device, to_numpy
from waveformanalysis_tpu_torch.dtypes.schema import Field, Schema
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.ops import widths as WD
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin

WAVEFORM_WIDTH_SCHEMA = Schema(
    "waveform_width",
    (
        Field("rise_time", "f4", unit="ns", doc="10%->90% rise time"),
        Field("fall_time", "f4", unit="ns", doc="90%->10% fall time"),
        Field("total_width", "f4", unit="ns", doc="10% rise -> 10% fall"),
        Field("rise_time_samples", "f4"),
        Field("fall_time_samples", "f4"),
        Field("total_width_samples", "f4"),
        Field("peak_position", "i8"),
        Field("peak_height", "f4"),
        Field("timestamp", "i8"),
        Field("board", "i2"),
        Field("channel", "i2"),
        Field("record_id", "i8"),
    ),
)
WAVEFORM_WIDTH_DTYPE = WAVEFORM_WIDTH_SCHEMA.numpy_dtype()


class WaveformWidthPlugin(Plugin):
    """Calculate rise/fall time based on peak detection results."""

    provides = "waveform_width"
    depends_on = []  # dynamic
    description = "Calculate rise/fall time based on peak detection results."
    version = "3.1.0"
    kernel_version = WD.KERNEL_VERSION
    save_when = "always"
    output_dtype = WAVEFORM_WIDTH_SCHEMA
    options = {
        "use_filtered": Option(default=False, type=bool,
                               help="Use filtered_waveforms for the crossings"),
        "sampling_rate": Option(default=None, type=float,
                                help="Sampling rate (GHz); default 0.5"),
        "rise_low": Option(default=0.1, type=float, help="Rise low fraction"),
        "rise_high": Option(default=0.9, type=float, help="Rise high fraction"),
        "fall_high": Option(default=0.9, type=float, help="Fall high fraction"),
        "fall_low": Option(default=0.1, type=float, help="Fall low fraction"),
        "interpolation": Option(default=True, type=bool,
                                help="Linear interpolation at crossings"),
        "width_backend": Option(
            default="auto", type=str, track=False,
            help=("Fused-path slot-width kernel: auto (scan on a CUDA "
                  "device, xla on the CPU), xla (K x 4 masked reductions "
                  "in plain PyTorch), scan (the CUDA kernel, "
                  "ops/width_scan_cuda.py). Untracked."),
        ),
    }

    def resolve_depends_on(self, context: Any, run_id: Optional[str] = None):
        if context.get_config(self, "use_filtered"):
            return ["hit", "filtered_waveforms"]
        return ["hit", "st_waveforms"]

    # -- three-phase structure (shared with the fused subgraph executor) ----

    def kernel_config(self, context: Any) -> dict:
        backend = scan_backend(
            context.get_config(self, "width_backend"), context.device
        )
        return {
            "backend": backend,
            "use_filtered": bool(context.get_config(self, "use_filtered")),
            "sampling_rate": float(
                context.get_config(self, "sampling_rate") or 0.5
            ),
            "rise_low": float(context.get_config(self, "rise_low")),
            "rise_high": float(context.get_config(self, "rise_high")),
            "fall_high": float(context.get_config(self, "fall_high")),
            "fall_low": float(context.get_config(self, "fall_low")),
            "interpolation": bool(context.get_config(self, "interpolation")),
        }

    def expected_wave_source(self, context: Any) -> str:
        """Wave source this plugin's crossings read (fusion planning)."""
        return ("filtered_waveforms"
                if context.get_config(self, "use_filtered") else "st_waveforms")

    @staticmethod
    def device_stage(cfg: dict, waves_d: Any, peaks_stage: dict) -> dict:
        """Composable device program: peak slots -> width slots.

        ``peaks_stage`` is the hit plugin's device_stage output over the SAME
        wave matrix; widths are computed for every fixed-capacity peak slot so
        the fused executor never round-trips the hit table to host between
        the two kernels (the standalone path re-uploads the full wave matrix
        after joining hits on host).
        """
        if cfg.get("backend") == "scan":
            return WD.width_from_peak_slots_scan(
                waves_d,
                peaks_stage["position"],
                peaks_stage["valid"],
                rise_low=cfg["rise_low"], rise_high=cfg["rise_high"],
                fall_high=cfg["fall_high"], fall_low=cfg["fall_low"],
                interpolation=cfg["interpolation"],
            )
        return WD.width_from_peak_slots(
            waves_d.to(torch.float32),
            peaks_stage["position"],
            peaks_stage["valid"],
            rise_low=cfg["rise_low"], rise_high=cfg["rise_high"],
            fall_high=cfg["fall_high"], fall_low=cfg["fall_low"],
            interpolation=cfg["interpolation"],
        )

    # slot fields the finalize step consumes, in the order the fused
    # executor's device compaction packs them (fusion.py _SLOT_FIELDS)
    COMPACT_SLOT_FIELDS = (
        "position", "rise_samples", "fall_samples", "total_samples",
        "peak_height", "width_valid",
    )

    def finalize_compact(
        self, cfg: dict, rows: np.ndarray, slots: dict, meta: dict,
        dt_ns: np.ndarray,
    ) -> Table:
        """Finalize from device-compacted width slots (fused path).

        ``rows``/``slots`` are aligned 1:1 with the emitted hit table
        (compacted with the hit valid mask in row-major order); the
        ``width_valid`` filter reproduces the standalone plugin's ``keep``
        mask, and the hit-column values (timestamp/board/channel/record_id)
        are recomputed from meta with the exact arithmetic of
        ops/peaks.hit_columns_from_flat — bit-identical to joining against
        the materialized hit table.
        """
        keep = np.flatnonzero(slots["width_valid"] != 0)
        rows_k = rows[keep]
        pos = slots["position"][keep].astype(np.int64)
        dt = np.asarray(dt_ns, dtype=np.int64)[rows_k]
        rate = float(cfg["sampling_rate"])
        rs = slots["rise_samples"][keep]
        fs = slots["fall_samples"][keep]
        ts_ = slots["total_samples"][keep]
        return Table(
            {
                "rise_time": (rs / rate).astype(np.float32),
                "fall_time": (fs / rate).astype(np.float32),
                "total_width": (ts_ / rate).astype(np.float32),
                "rise_time_samples": rs.astype(np.float32),
                "fall_time_samples": fs.astype(np.float32),
                "total_width_samples": ts_.astype(np.float32),
                "peak_position": pos,
                "peak_height": slots["peak_height"][keep].astype(np.float32),
                "timestamp": np.asarray(meta["timestamp"], np.int64)[rows_k]
                + pos * dt * 1000,
                "board": np.asarray(meta["board"], np.int16)[rows_k],
                "channel": np.asarray(meta["channel"], np.int16)[rows_k],
                "record_id": np.asarray(meta["record_id"], np.int64)[rows_k],
            },
            schema=WAVEFORM_WIDTH_SCHEMA,
        )

    def finalize(self, cfg: dict, out: dict, meta: dict,
                 dt_ns: np.ndarray) -> Table:
        """Finalize from raw (n, K) slot arrays (unpacked path)."""
        out = {k: to_numpy(v) for k, v in out.items()}
        hit_valid = out["valid"].reshape(-1)
        rows_all = np.repeat(
            np.arange(out["valid"].shape[0], dtype=np.int64),
            out["valid"].shape[1],
        )
        sel = np.flatnonzero(hit_valid)
        slots = {
            f: out[f].reshape(-1)[sel] for f in self.COMPACT_SLOT_FIELDS
        }
        return self.finalize_compact(cfg, rows_all[sel], slots, meta, dt_ns)

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        use_filtered = context.get_config(self, "use_filtered")
        sampling_rate = context.get_config(self, "sampling_rate") or 0.5
        rise_low = float(context.get_config(self, "rise_low"))
        rise_high = float(context.get_config(self, "rise_high"))
        fall_high = float(context.get_config(self, "fall_high"))
        fall_low = float(context.get_config(self, "fall_low"))
        interpolation = bool(context.get_config(self, "interpolation"))

        hits = context.get_data(run_id, "hit")
        source = "filtered_waveforms" if use_filtered else "st_waveforms"
        data = context.get_data(run_id, source)
        if not isinstance(hits, Table):
            hits = Table.from_numpy(hits)
        if not isinstance(data, Table):
            data = Table.from_numpy(data)
        if len(hits) == 0 or len(data) == 0:
            return Table.zeros(0, WAVEFORM_WIDTH_SCHEMA)

        # join hits -> waveform rows by record_id (vectorized)
        rec_ids = np.asarray(data["record_id"], dtype=np.int64) \
            if "record_id" in data else np.arange(len(data), dtype=np.int64)
        hit_rid = np.asarray(hits["record_id"], dtype=np.int64)
        order = np.argsort(rec_ids, kind="stable")
        pos_in_sorted = np.searchsorted(rec_ids[order], hit_rid)
        pos_in_sorted = np.clip(pos_in_sorted, 0, len(order) - 1)
        rows = order[pos_in_sorted]
        matched = rec_ids[rows] == hit_rid
        if not np.any(matched):
            return Table.zeros(0, WAVEFORM_WIDTH_SCHEMA)
        rows = rows[matched]
        hit_sel = np.flatnonzero(matched)

        waves = np.asarray(data["wave"])[rows]
        peak_pos = np.asarray(hits["position"], dtype=np.int64)[hit_sel]

        dev = context.device
        out = WD.width_from_peaks(
            to_device(waves.astype(np.float32), dev),
            to_device(peak_pos.astype(np.int32), dev),
            rise_low=rise_low, rise_high=rise_high,
            fall_high=fall_high, fall_low=fall_low,
            interpolation=interpolation,
        )
        out = {k: to_numpy(v) for k, v in out.items()}
        valid = out["valid"]
        keep = np.flatnonzero(valid)
        hit_keep = hit_sel[keep]

        rate = float(sampling_rate)
        rs = out["rise_samples"][keep]
        fs = out["fall_samples"][keep]
        ts_ = out["total_samples"][keep]
        return Table(
            {
                "rise_time": (rs / rate).astype(np.float32),
                "fall_time": (fs / rate).astype(np.float32),
                "total_width": (ts_ / rate).astype(np.float32),
                "rise_time_samples": rs.astype(np.float32),
                "fall_time_samples": fs.astype(np.float32),
                "total_width_samples": ts_.astype(np.float32),
                "peak_position": peak_pos[keep],
                "peak_height": out["peak_height"][keep].astype(np.float32),
                "timestamp": np.asarray(hits["timestamp"], np.int64)[hit_keep],
                "board": np.asarray(hits["board"], np.int16)[hit_keep]
                if "board" in hits else np.zeros(len(keep), np.int16),
                "channel": np.asarray(hits["channel"], np.int16)[hit_keep],
                "record_id": hit_rid[hit_keep],
            },
            schema=WAVEFORM_WIDTH_SCHEMA,
        )
