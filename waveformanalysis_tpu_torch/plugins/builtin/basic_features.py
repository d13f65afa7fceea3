"""basic_features plugin: height / amp / area / max_abs_diff per event.

Behavioral analog of the reference BasicFeaturesPlugin
(reference: waveform_analysis/core/plugins/builtin/cpu/basic_features.py:43),
with identical options (height_range, area_range, use_filtered, wave_source,
fixed_baseline [deprecated], channel_config) and numeric semantics — but the
per-event Python loop is replaced by one device sweep over the padded wave
matrix (see waveformanalysis_tpu_torch/ops/features.py), with per-channel
fixed_baseline overrides resolved vectorized instead of per record.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import to_device, to_numpy
from waveformanalysis_tpu_torch.dtypes.schema import BASIC_FEATURES_SCHEMA
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.foundation.constants import FeatureDefaults
from waveformanalysis_tpu_torch.hardware import resolve_channel_value_arrays
from waveformanalysis_tpu_torch.ops import features as F
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin
from waveformanalysis_tpu_torch.plugins.builtin._wave_source import (
    wave_matrix_view,
    WAVE_SOURCE_AUTO,
    load_wave_input,
    resolve_wave_input_spec,
)

BASIC_FEATURES_DTYPE = BASIC_FEATURES_SCHEMA.numpy_dtype()


class BasicFeaturesPlugin(Plugin):
    """Compute basic height/amp/area/max_abs_diff features from waveforms."""

    provides = "basic_features"
    # outputs depend on run_config channel_metadata (hardware overrides)
    uses_run_config = True
    depends_on = []  # dynamic via resolve_depends_on
    description = (
        "Compute basic height, amplitude, area, and max-abs-diff features "
        "from waveform data."
    )
    version = "4.1.0"  # 4.1: auto wave_source = st (reference semantics)
    kernel_version = F.KERNEL_VERSION
    save_when = "always"
    output_dtype = BASIC_FEATURES_DTYPE
    options = {
        "height_range": Option(
            default=FeatureDefaults.PEAK_RANGE, type=tuple,
            help="Sample window (start, end) for height/amp",
        ),
        "area_range": Option(
            default=(0, None), type=tuple,
            help="Sample window (start, end) for area; end=None -> wave end",
        ),
        "use_filtered": Option(
            default=False, type=bool,
            help="Use filtered_waveforms (requires FilteredWaveformsPlugin)",
        ),
        "wave_source": Option(
            default=WAVE_SOURCE_AUTO, type=str,
            help="Wave source: auto|records|st_waveforms|filtered_waveforms",
        ),
        "fixed_baseline": Option(
            default=None, type=dict,
            help="Deprecated; use channel_config for per-channel fixed baselines.",
        ),
        "channel_config": Option(
            default=None, type=dict,
            help="Per-(board,channel) overrides; may override fixed_baseline.",
        ),
    }

    def resolve_depends_on(self, context: Any, run_id: str | None = None):
        return list(resolve_wave_input_spec(context, self).depends_on)

    # -- three-phase structure (shared with the fused subgraph executor) ----

    def kernel_config(self, context: Any) -> dict:
        return {
            "height_range": tuple(context.get_config(self, "height_range")),
            "area_range": tuple(context.get_config(self, "area_range")),
            "channel_config": context.get_config(self, "channel_config"),
        }

    def host_prep(
        self, cfg: dict, context: Any, run_id: str,
        baselines: np.ndarray, boards: np.ndarray, channels: np.ndarray,
    ) -> np.ndarray:
        """Apply per-channel fixed_baseline overrides (host config machinery)."""
        overrides = resolve_channel_value_arrays(
            context, self, run_id, boards, channels,
            option_names=("fixed_baseline",),
            defaults={"fixed_baseline": None},
            channel_config=cfg["channel_config"],
        )
        fixed = overrides["fixed_baseline"]
        has_fixed = ~np.isnan(fixed)
        baselines = baselines.copy()
        baselines[has_fixed] = fixed[has_fixed]
        return baselines

    @staticmethod
    def normalized_windows(cfg: dict, L: int) -> tuple:
        """(height_start, height_end, area_start, area_end) vs padded L."""
        hs, he = cfg["height_range"]
        as_, ae = cfg["area_range"]
        hs, he = F._norm_window(int(hs), None if he is None else int(he), L)
        as_, ae = F._norm_window(int(as_), None if ae is None else int(ae), L)
        return hs, he, as_, ae

    # packed-transfer layout: all six reductions are int32, so one (n, 6)
    # stack crosses to the host in one copy
    _RED_FIELDS = ("min_h", "max_h", "count_h", "sum_a", "count_a",
                   "max_abs_diff")

    @staticmethod
    def device_stage(cfg: dict, waves_d: Any, lengths_d: Any) -> dict:
        """Composable device program: exact integer reductions."""
        L = waves_d.shape[1]
        if L >= 65536:
            raise ValueError(
                f"wave length {L} >= 65536 would overflow the exact int32 "
                "area accumulator"
            )
        hs, he, as_, ae = BasicFeaturesPlugin.normalized_windows(cfg, L)
        red = F.feature_reductions(
            waves_d, lengths_d.to(torch.int32),
            height_start=hs, height_end=he, area_start=as_, area_end=ae,
        )
        # event-major (n, 6): the leading dim stays the event axis
        return {"packed": torch.stack(
            [red[k] for k in BasicFeaturesPlugin._RED_FIELDS], dim=1
        )}

    def finalize(
        self, cfg: dict, red: dict, baselines: np.ndarray, pol: np.ndarray,
        timestamps: np.ndarray, boards: np.ndarray, channels: np.ndarray,
    ) -> Table:
        """Exact float64 host combine + Table build."""
        if "packed" in red:
            packed = to_numpy(red["packed"])
            red_host = {
                k: packed[:, i] for i, k in enumerate(self._RED_FIELDS)
            }
        else:
            red_host = {k: to_numpy(v) for k, v in red.items()}
        feats = F.combine_features(red_host, baselines, pol)
        n = len(baselines)
        return Table(
            {
                "height": feats["height"],
                "amp": feats["amp"],
                "area": feats["area"],
                "max_abs_diff": feats["max_abs_diff"],
                "timestamp": timestamps,
                "board": boards.astype(np.int16),
                "channel": channels.astype(np.int16),
                "event_index": np.arange(n, dtype=np.int64),
            },
            schema=BASIC_FEATURES_SCHEMA,
        )

    def load_input(self, context: Any, run_id: str) -> Optional[dict]:
        """Waves + metadata from the configured source (records or flat).

        Returns None for the empty input; otherwise a dict with wave matrix,
        event_length, raw baselines, polarity codes and identity columns.
        """
        wave_input = load_wave_input(context, self, run_id, needs_wave_samples=True)
        if wave_input.spec.is_records:
            records = wave_input.records
            rv = wave_input.records_view
            if records is None or rv is None:
                raise ValueError(
                    "basic_features failed to load records_view for records source"
                )
            n = len(records)
            if n == 0:
                return None
            # float32 keeps a FILTERED (f32) pool exact; raw uint16 pools
            # are exactly representable in f32 too
            waves, event_length = rv.padded_wave_matrix(dtype=np.float32)
            boards = np.asarray(records["board"]) if "board" in records \
                else np.zeros(n, np.int16)
            channels = np.asarray(records["channel"]) if "channel" in records \
                else np.zeros(n, np.int16)
            pol = (
                np.asarray(records["polarity"]).astype(np.int8)
                if "polarity" in records else np.full(n, -1, np.int8)
            )
            baselines = np.asarray(records["baseline"], dtype=np.float64)
            timestamps = np.asarray(records["timestamp"], dtype=np.int64)
        else:
            data = wave_input.waveform_data
            if data is None:
                raise ValueError(
                    f"basic_features failed to load {wave_input.spec.expected_name}"
                )
            n = len(data)
            if n == 0:
                return None
            waves = wave_matrix_view(data["wave"])
            event_length = (
                np.asarray(data["event_length"], dtype=np.int32)
                if "event_length" in data
                else np.full(n, waves.shape[1], dtype=np.int32)
            )
            boards = (
                np.asarray(data["board"]) if "board" in data
                else np.zeros(n, dtype=np.int16)
            )
            channels = (
                np.asarray(data["channel"]) if "channel" in data
                else np.zeros(n, dtype=np.int16)
            )
            pol = (
                np.asarray(data["polarity"]).astype(np.int8)
                if "polarity" in data else np.full(n, -1, dtype=np.int8)
            )
            baselines = np.asarray(data["baseline"], dtype=np.float64)
            timestamps = (
                np.asarray(data["timestamp"], dtype=np.int64)
                if "timestamp" in data else np.zeros(n, dtype=np.int64)
            )
        # unknown polarity falls back to negative (reference behavior)
        pol = np.where(pol == 0, np.int8(-1), pol)
        return {
            "waves": waves,
            "event_length": np.asarray(event_length, dtype=np.int32),
            "baselines": baselines,
            "polarity": pol,
            "timestamps": timestamps,
            "boards": boards,
            "channels": channels,
        }

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        cfg = self.kernel_config(context)
        inp = self.load_input(context, run_id)
        if inp is None:
            return Table.zeros(0, BASIC_FEATURES_SCHEMA)
        baselines = self.host_prep(
            cfg, context, run_id, inp["baselines"], inp["boards"], inp["channels"]
        )
        dev = context.device
        red = self.device_stage(
            cfg, to_device(wave_matrix_view(inp["waves"]), dev),
            to_device(inp["event_length"], dev),
        )
        return self.finalize(
            cfg, red, baselines, inp["polarity"],
            inp["timestamps"], inp["boards"], inp["channels"],
        )
