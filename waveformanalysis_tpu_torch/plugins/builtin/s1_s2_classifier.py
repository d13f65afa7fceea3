"""s1_s2 plugin: classify peaks into S1/S2 via range checks.

Behavioral analog of the reference S1S2ClassifierPlugin
(reference: waveform_analysis/core/plugins/builtin/cpu/s1_s2_classifier.py:
73-240): joins waveform_width rows to basic_features by record_id, checks
width/area/height ranges per class (None disables a bound), and resolves
conflicts by policy. The reference per-peak loop is vectorized.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from waveformanalysis_tpu_torch.dtypes.schema import Field, Schema
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin

LABEL_UNKNOWN = 0
LABEL_S1 = 1
LABEL_S2 = 2

S1_S2_CLASSIFIER_SCHEMA = Schema(
    "s1_s2",
    (
        Field("label", "i1", doc="0 unknown, 1 S1, 2 S2"),
        Field("width_ns", "f4"),
        Field("width_samples", "f4"),
        Field("height", "f4"),
        Field("area", "f4"),
        Field("timestamp", "i8"),
        Field("board", "i2"),
        Field("channel", "i2"),
        Field("record_id", "i8"),
        Field("peak_position", "i8"),
    ),
)
S1_S2_CLASSIFIER_DTYPE = S1_S2_CLASSIFIER_SCHEMA.numpy_dtype()


def _normalize_range(value: Any) -> Optional[Tuple[Optional[float], Optional[float]]]:
    if value is None:
        return None
    if not isinstance(value, (tuple, list)) or len(value) != 2:
        raise ValueError("range must be a tuple of (min, max)")
    lo, hi = value
    if lo is None and hi is None:
        return None
    return (None if lo is None else float(lo), None if hi is None else float(hi))


def _in_range(values: np.ndarray, bounds) -> np.ndarray:
    if bounds is None:
        return np.ones(len(values), dtype=bool)
    ok = ~np.isnan(values)
    lo, hi = bounds
    if lo is not None:
        ok &= values >= lo
    if hi is not None:
        ok &= values <= hi
    return ok


class S1S2ClassifierPlugin(Plugin):
    """Classify peaks into S1/S2/Unknown using width + basic features."""

    provides = "s1_s2"
    depends_on = ["waveform_width", "basic_features"]
    description = "Classify peaks into S1/S2 using width/area/height ranges."
    version = "0.4.0"
    save_when = "always"
    output_dtype = S1_S2_CLASSIFIER_SCHEMA
    options = {
        "width_unit": Option(default="ns", type=str, choices=["ns", "samples"],
                             help="Width unit for range checks"),
        "s1_width_range": Option(default=None, type=tuple,
                                 help="S1 width (min, max); None disables"),
        "s2_width_range": Option(default=None, type=tuple,
                                 help="S2 width (min, max); None disables"),
        "s1_area_range": Option(default=None, type=tuple,
                                help="S1 area (min, max); None disables"),
        "s2_area_range": Option(default=None, type=tuple,
                                help="S2 area (min, max); None disables"),
        "s1_height_range": Option(default=None, type=tuple,
                                  help="S1 height (min, max); None disables"),
        "s2_height_range": Option(default=None, type=tuple,
                                  help="S2 height (min, max); None disables"),
        "conflict_policy": Option(default="unknown", type=str,
                                  choices=["unknown", "prefer_s1", "prefer_s2"],
                                  help="Resolution when both classes match"),
        "strict": Option(default=False, type=bool,
                         help="Raise when no criteria configured"),
    }

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        widths = context.get_data(run_id, "waveform_width")
        features = context.get_data(run_id, "basic_features")
        return self.classify(self.kernel_config(context), widths, features)

    # -- two-phase structure (shared with the fused subgraph executor) -------

    def kernel_config(self, context: Any) -> dict:
        """Resolve + validate every option the classification depends on."""
        return {
            "width_unit": context.get_config(self, "width_unit"),
            "s1_width_range": _normalize_range(
                context.get_config(self, "s1_width_range")),
            "s2_width_range": _normalize_range(
                context.get_config(self, "s2_width_range")),
            "s1_area_range": _normalize_range(
                context.get_config(self, "s1_area_range")),
            "s2_area_range": _normalize_range(
                context.get_config(self, "s2_area_range")),
            "s1_height_range": _normalize_range(
                context.get_config(self, "s1_height_range")),
            "s2_height_range": _normalize_range(
                context.get_config(self, "s2_height_range")),
            "conflict_policy": context.get_config(self, "conflict_policy"),
            "strict": bool(context.get_config(self, "strict")),
        }

    @staticmethod
    def classify(cfg: dict, widths: Any, features: Any) -> Table:
        """Pure classification from materialized width/feature tables.

        The standalone compute and the fused executor both call this, so
        fused outputs are bit-identical by construction (hits are orders of
        magnitude fewer than samples — this stays a host pass).
        """
        if not isinstance(widths, Table):
            widths = Table.from_numpy(widths)
        if not isinstance(features, Table):
            features = Table.from_numpy(features)

        width_unit = cfg["width_unit"]
        s1_w, s2_w = cfg["s1_width_range"], cfg["s2_width_range"]
        s1_a, s2_a = cfg["s1_area_range"], cfg["s2_area_range"]
        s1_h, s2_h = cfg["s1_height_range"], cfg["s2_height_range"]
        conflict_policy = cfg["conflict_policy"]

        s1_enabled = any(r is not None for r in (s1_w, s1_a, s1_h))
        s2_enabled = any(r is not None for r in (s2_w, s2_a, s2_h))
        if cfg["strict"] and not s1_enabled and not s2_enabled:
            raise ValueError(
                "No S1/S2 criteria configured; set ranges or disable strict."
            )

        n = len(widths)
        if n == 0:
            return Table.zeros(0, S1_S2_CLASSIFIER_SCHEMA)

        width_ns = np.asarray(widths["total_width"], dtype=np.float64)
        width_samples = np.asarray(widths["total_width_samples"], dtype=np.float64)
        rid = np.asarray(widths["record_id"], dtype=np.int64)

        # join features by record_id (first match, reference semantics)
        f_rid = np.asarray(features["record_id"], dtype=np.int64) \
            if "record_id" in features else np.asarray(
                features["event_index"], dtype=np.int64)
        height = np.full(n, np.nan)
        area = np.full(n, np.nan)
        if len(features):
            order = np.argsort(f_rid, kind="stable")
            pos = np.searchsorted(f_rid[order], rid)
            pos = np.clip(pos, 0, len(order) - 1)
            rows = order[pos]
            match = f_rid[rows] == rid
            height[match] = np.asarray(features["height"], np.float64)[rows[match]]
            area[match] = np.asarray(features["area"], np.float64)[rows[match]]

        width_value = width_samples if width_unit == "samples" else width_ns

        s1_ok = (
            np.full(n, s1_enabled)
            & _in_range(width_value, s1_w)
            & _in_range(area, s1_a)
            & _in_range(height, s1_h)
        )
        s2_ok = (
            np.full(n, s2_enabled)
            & _in_range(width_value, s2_w)
            & _in_range(area, s2_a)
            & _in_range(height, s2_h)
        )

        label = np.zeros(n, dtype=np.int8)
        label[s1_ok & ~s2_ok] = LABEL_S1
        label[s2_ok & ~s1_ok] = LABEL_S2
        both = s1_ok & s2_ok
        if conflict_policy == "prefer_s1":
            label[both] = LABEL_S1
        elif conflict_policy == "prefer_s2":
            label[both] = LABEL_S2

        return Table(
            {
                "label": label,
                "width_ns": width_ns.astype(np.float32),
                "width_samples": width_samples.astype(np.float32),
                "height": height.astype(np.float32),
                "area": area.astype(np.float32),
                "timestamp": np.asarray(widths["timestamp"], np.int64),
                "board": np.asarray(widths["board"], np.int16)
                if "board" in widths else np.zeros(n, np.int16),
                "channel": np.asarray(widths["channel"], np.int16),
                "record_id": rid,
                "peak_position": np.asarray(widths["peak_position"], np.int64),
            },
            schema=S1_S2_CLASSIFIER_SCHEMA,
        )
