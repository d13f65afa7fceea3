"""waveform_width_integral plugin: event-level integral quantile width.

Behavioral analog of the reference WaveformWidthIntegralPlugin
(reference: waveform_analysis/core/plugins/builtin/cpu/
waveform_width_integral.py:42): baseline always comes from the source's
baseline field, the polarity-normalized signal is clamped at zero, and
t_low/t_high are searchsorted positions of q_low/q_high on the cumulative
integral. The per-event Python loop is one device call.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import to_device, to_numpy
from waveformanalysis_tpu_torch.dtypes.schema import Field, Schema
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.ops import widths as WD
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin
from waveformanalysis_tpu_torch.plugins.builtin._wave_source import (
    WAVE_SOURCE_AUTO,
    load_wave_input,
    resolve_wave_input_spec,
)

WAVEFORM_WIDTH_INTEGRAL_SCHEMA = Schema(
    "waveform_width_integral",
    (
        Field("t_low", "f4", unit="ns"),
        Field("t_high", "f4", unit="ns"),
        Field("width", "f4", unit="ns"),
        Field("t_low_samples", "f4"),
        Field("t_high_samples", "f4"),
        Field("width_samples", "f4"),
        Field("q_total", "f8", doc="total charge after baseline correction"),
        Field("timestamp", "i8"),
        Field("board", "i2"),
        Field("channel", "i2"),
        Field("event_index", "i8"),
    ),
)
WAVEFORM_WIDTH_INTEGRAL_DTYPE = WAVEFORM_WIDTH_INTEGRAL_SCHEMA.numpy_dtype()


class WaveformWidthIntegralPlugin(Plugin):
    """Event-wise integral quantile width."""

    provides = "waveform_width_integral"
    depends_on = []  # dynamic
    description = (
        "Event-wise integral quantile width using st_waveforms or "
        "filtered_waveforms."
    )
    version = "2.8.0"
    kernel_version = WD.KERNEL_VERSION
    save_when = "always"
    output_dtype = WAVEFORM_WIDTH_INTEGRAL_SCHEMA
    options = {
        "q_low": Option(default=0.10, type=float, help="Low quantile"),
        "q_high": Option(default=0.90, type=float, help="High quantile"),
        "use_filtered": Option(default=False, type=bool,
                               help="Use filtered_waveforms (baseline stays upstream)"),
        "wave_source": Option(default=WAVE_SOURCE_AUTO, type=str,
                              help="auto|records|st_waveforms|filtered_waveforms"),
        "sampling_rate": Option(default=0.5, type=float,
                                help="Sampling rate (GHz) for ns conversion"),
        "dt": Option(default=None, type=float,
                     help="Sample interval (ns); overrides sampling_rate"),
    }

    def resolve_depends_on(self, context: Any, run_id: Optional[str] = None):
        return list(resolve_wave_input_spec(context, self).depends_on)

    # -- three-phase structure (shared with the fused subgraph executor) ----

    def kernel_config(self, context: Any) -> dict:
        q_low = float(context.get_config(self, "q_low"))
        q_high = float(context.get_config(self, "q_high"))
        dt = context.get_config(self, "dt")
        sampling_rate = context.get_config(self, "sampling_rate")
        if dt is None:
            if sampling_rate <= 0:
                raise ValueError(f"sampling_rate ({sampling_rate}) must be > 0")
            dt = 1.0 / float(sampling_rate)
        if q_low <= 0 or q_high >= 1 or q_low >= q_high:
            raise ValueError(
                f"invalid q_low/q_high: q_low={q_low}, q_high={q_high}"
            )
        return {"q_low": q_low, "q_high": q_high, "dt": float(dt)}

    @staticmethod
    def device_stage(
        cfg: dict,
        waves_d: Any,
        lengths_d: Any,
        sign_d: Any,
        baselines_d: Any,
    ) -> dict:
        """Composable device program: signal -> quantile widths.

        The kernel masks by event length itself, so computing the signal
        from (waves, baseline, sign) matches both the flat path and the
        zero-padded records signal_matrix exactly.
        """
        w32 = waves_d.to(torch.float32)
        signal = sign_d[:, None] * (w32 - baselines_d[:, None].to(torch.float32))
        return dict(WD.integral_quantile_width(
            signal, lengths_d.to(torch.int32),
            q_low=cfg["q_low"], q_high=cfg["q_high"],
        ))

    def finalize(self, cfg: dict, out: dict, meta: Any, n: int) -> Table:
        out = {k: to_numpy(v) for k, v in out.items()}
        dt_f = cfg["dt"]
        return Table(
            {
                "t_low": (out["t_low_samples"] * dt_f).astype(np.float32),
                "t_high": (out["t_high_samples"] * dt_f).astype(np.float32),
                "width": (out["width_samples"] * dt_f).astype(np.float32),
                "t_low_samples": out["t_low_samples"].astype(np.float32),
                "t_high_samples": out["t_high_samples"].astype(np.float32),
                "width_samples": out["width_samples"].astype(np.float32),
                "q_total": out["q_total"].astype(np.float64),
                "timestamp": np.asarray(meta["timestamp"], np.int64)
                if "timestamp" in meta else np.zeros(n, np.int64),
                "board": np.asarray(meta["board"], np.int16)
                if "board" in meta else np.zeros(n, np.int16),
                "channel": np.asarray(meta["channel"], np.int16)
                if "channel" in meta else np.zeros(n, np.int16),
                "event_index": np.arange(n, dtype=np.int64),
            },
            schema=WAVEFORM_WIDTH_INTEGRAL_SCHEMA,
        )

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        cfg = self.kernel_config(context)
        q_low, q_high, dt = cfg["q_low"], cfg["q_high"], cfg["dt"]

        wave_input = load_wave_input(context, self, run_id, needs_wave_samples=True)
        data = wave_input.waveform_data
        n = len(data)
        if n == 0:
            return Table.zeros(0, WAVEFORM_WIDTH_INTEGRAL_SCHEMA)
        waves = np.asarray(data["wave"]).astype(np.float32)
        baseline = np.asarray(data["baseline"], dtype=np.float64) \
            if "baseline" in data else np.zeros(n)
        pol = np.asarray(data["polarity"], dtype=np.int8) \
            if "polarity" in data else np.full(n, -1, np.int8)
        sign = np.where(pol > 0, 1.0, -1.0).astype(np.float32)
        signal = sign[:, None] * (waves - baseline[:, None].astype(np.float32))
        lengths = (
            np.asarray(data["event_length"], dtype=np.int32)
            if "event_length" in data
            else np.full(n, waves.shape[1], np.int32)
        )

        dev = context.device
        out = WD.integral_quantile_width(
            to_device(signal, dev), to_device(np.asarray(lengths, np.int32), dev),
            q_low=q_low, q_high=q_high,
        )
        return self.finalize(cfg, out, data, len(lengths))
