"""filtered_waveforms plugin: per-channel digital filtering of st_waveforms.

Port of ``waveformanalysis_tpu/plugins/builtin/filtering.py`` (behavioral
analog of the reference FilteredWaveformsPlugin, reference:
waveform_analysis/core/plugins/builtin/cpu/filtering.py:410): options
filter_type {BW, SG}, lowcut/highcut/fs/filter_order,
sg_window_size/sg_poly_order, with per-hardware-channel overrides through
``channel_config``; output mirrors the source table with float32 waves.

``engine="device"`` filters on the Context's device: the wave matrix is
copied there once, each hardware channel's rows are gathered, filtered (the
K5 kernel for BW on a CUDA device, the plain PyTorch version on the CPU)
and scattered into one float32 matrix, and that matrix is the table's
``wave`` column on the device, where the fused program and the standalone
plugins of the same request read it without a host round trip; when the
outermost ``get_data`` returns, the Context moves it to the host (a NumPy
float32 matrix, as the JAX plugin returns). Saving the table (when it is a
target) writes f4 waves that reload as f4. ``engine="scipy"`` is the host
reference and returns a host column.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import to_device, to_numpy
from waveformanalysis_tpu_torch.dtypes.schema import Field, ST_WAVEFORM_SCHEMA
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.hardware import (
    group_indices_by_hardware_channel,
    resolve_effective_channel_config,
)
from waveformanalysis_tpu_torch.ops import filtering as FLT
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin

logger = logging.getLogger(__name__)

FILTER_ENGINE_VERSION = "3.1.0"  # 3.1: own schema name (cached f4 waves no longer reload as int16)
FILTER_OPTION_NAMES = (
    "filter_type",
    "lowcut",
    "highcut",
    "fs",
    "filter_order",
    "sg_window_size",
    "sg_poly_order",
)

FILTERED_WAVEFORM_SCHEMA = ST_WAVEFORM_SCHEMA.replace_field(
    "wave", Field("wave", "f4", shape=("wave_length",), unit="ADC",
                  doc="filtered samples (float32)"),
    name="filtered_waveforms",  # own name: cache reloads re-attach the
    # schema BY NAME, and the st schema would floor waves back to int16
)


def create_filtered_waveform_dtype(source_dtype: np.dtype) -> np.dtype:
    """Source dtype with the wave field converted to float32
    (reference: filtering.py:133)."""
    names = source_dtype.names or ()
    if "wave" not in names:
        raise ValueError("source dtype missing required 'wave' field")
    fields = []
    for name in names:
        fd = source_dtype.fields[name][0]
        sub = fd.subdtype
        if name == "wave":
            fields.append((name, np.float32, sub[1]) if sub else (name, np.float32))
        elif sub:
            fields.append((name, sub[0], sub[1]))
        else:
            fields.append((name, fd))
    return np.dtype(fields)


def get_filter_base_values(context: Any, plugin: Plugin) -> Dict[str, Any]:
    return {name: context.get_config(plugin, name) for name in FILTER_OPTION_NAMES}


def resolve_filter_config(
    context: Any,
    plugin: Plugin,
    run_id: Optional[str] = None,
    board: Optional[int] = None,
    channel: Optional[int] = None,
    base_values: Optional[Dict[str, Any]] = None,
    channel_config: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Resolve + validate filter config, with per-channel overrides.

    Returns {"filter_type", "bw_sos", "sg_window_size", "sg_poly_order"}.
    """
    values = dict(base_values or get_filter_base_values(context, plugin))
    if channel_config is None and "channel_config" in plugin.options:
        candidate = context.get_config(plugin, "channel_config")
        if isinstance(candidate, dict):
            channel_config = candidate
    if run_id is not None and board is not None and channel is not None:
        rule = resolve_effective_channel_config(
            context, plugin, run_id, board, channel,
            base_values=values, channel_config=channel_config,
        )
        values = dict(rule.values)

    filter_type = str(values["filter_type"])
    if filter_type not in ("BW", "SG"):
        raise ValueError(
            f"Unsupported filter type: {filter_type}. Use 'BW' or 'SG'."
        )
    out: Dict[str, Any] = {
        "filter_type": filter_type,
        "bw_sos": None,
        "sg_window_size": None,
        "sg_poly_order": None,
    }
    if filter_type == "BW":
        out["bw_sos"] = FLT.design_butterworth_sos(
            order=int(values["filter_order"]),
            lowcut=float(values["lowcut"]),
            highcut=float(values["highcut"]),
            fs=float(values["fs"]),
        )
    else:
        window = int(values["sg_window_size"])
        poly = int(values["sg_poly_order"])
        if window <= 0:
            raise ValueError(f"SG window size ({window}) must be > 0")
        if poly < 0:
            raise ValueError(f"SG poly order ({poly}) must be >= 0")
        if window % 2 == 0:
            window += 1
            logger.warning("SG window size adjusted to odd: %s", window)
        if poly >= window:
            raise ValueError(
                f"SG poly order ({poly}) must be < window size ({window})"
            )
        out["sg_window_size"] = window
        out["sg_poly_order"] = poly
    return out


class FilteredWaveformsPlugin(Plugin):
    """Digital filtering of structured waveforms (float32 output waves)."""

    provides = "filtered_waveforms"
    # outputs depend on run_config channel_metadata (hardware overrides)
    uses_run_config = True
    depends_on = ["st_waveforms"]
    description = "Apply Butterworth band-pass or Savitzky-Golay filtering."
    version = FILTER_ENGINE_VERSION
    kernel_version = FLT.KERNEL_VERSION
    save_when = "target"
    output_dtype = FILTERED_WAVEFORM_SCHEMA
    # GHz convention for fs/lowcut/highcut, matching the reference options
    # (filtering.py:420-424) and the adapter-inferred `fs` (GHz).
    options = {
        "filter_type": Option(default="SG", type=str, choices=["BW", "SG"],
                              help="Filter family: Butterworth or Savitzky-Golay"),
        "lowcut": Option(default=0.1, type=float, help="BW low cut (GHz)"),
        "highcut": Option(default=0.5, type=float, help="BW high cut (GHz)"),
        "fs": Option(default=0.5, type=float, help="BW sampling rate (GHz)"),
        "filter_order": Option(default=4, type=int, help="Butterworth order"),
        "sg_window_size": Option(default=11, type=int, help="SG window (samples, odd)"),
        "sg_poly_order": Option(default=2, type=int, help="SG polynomial order"),
        "max_workers": Option(default=None, type=int, track=False,
                              help="Accepted for API parity (device path ignores it)"),
        "batch_size": Option(default=0, type=int, track=False,
                             help="Events per filter batch (0 = whole channel)"),
        # the JAX package's help text, word for word: it feeds `spec_hash` and so every lineage key
        "channel_config": Option(default=None, type=dict,
                                 help="Per-(board,channel) filter overrides"),
        "engine": Option(default="device", type=str, track=False,
                         choices=["device", "scipy"],
                         help="Kernel engine (perf knob, untracked)"),
    }

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        data = context.get_data(run_id, "st_waveforms")
        if not isinstance(data, Table):
            data = Table.from_numpy(data)
        n = len(data)
        if n == 0:
            return Table(
                dict(data.columns, wave=np.asarray(data["wave"], dtype=np.float32)),
                schema=FILTERED_WAVEFORM_SCHEMA, validate=False,
            )
        engine = context.get_config(self, "engine")
        channel_config = context.get_config(self, "channel_config")
        base_values = get_filter_base_values(context, self)

        groups = group_indices_by_hardware_channel(
            np.asarray(data.get("board", np.zeros(n, np.int16))),
            np.asarray(data.get("channel", np.zeros(n, np.int16))),
        )
        configs = {
            hw: resolve_filter_config(
                context, self, run_id=run_id, board=hw.board, channel=hw.channel,
                base_values=base_values, channel_config=channel_config,
            )
            for hw in groups
        }
        if engine == "scipy":
            waves = to_numpy(data["wave"])
            out_waves = np.empty(waves.shape, dtype=np.float32)
            for hw, idx in groups.items():
                out_waves[idx] = self._filter(waves[idx], configs[hw], "scipy")
        else:
            out_waves = self._filter_on_device(context, data["wave"], groups, configs)

        cols = dict(data.columns)
        cols["wave"] = out_waves
        return Table(cols, schema=FILTERED_WAVEFORM_SCHEMA, validate=False)

    @staticmethod
    def _filter(waves: Any, cfg: Dict[str, Any], engine: str) -> Any:
        return FLT.apply_filter(
            waves, cfg["filter_type"], bw_sos=cfg["bw_sos"],
            sg_window_size=cfg["sg_window_size"],
            sg_poly_order=cfg["sg_poly_order"], engine=engine,
        )

    def _filter_on_device(self, context: Any, wave_col: Any, groups: Dict,
                          configs: Dict) -> torch.Tensor:
        """One float32 (n, L) matrix on the Context's device: each hardware
        channel's rows gathered, filtered and scattered back (one group of
        all rows in order is filtered in place of the whole matrix). The
        ``filtered_waveforms.*`` profiler phases end when the device is done."""
        dev = context.device
        prof = context.profiler

        def done() -> None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        with prof.time("filtered_waveforms.upload"):
            waves = to_device(wave_col, dev)
            done()
        if len(groups) == 1:
            (hw,) = groups
            with prof.time("filtered_waveforms.filter"):
                out = self._filter(waves, configs[hw], "device")
                done()
            return out
        out = torch.empty(waves.shape, dtype=torch.float32, device=dev)
        for hw, idx in groups.items():
            with prof.time("filtered_waveforms.gather"):
                idx_d = to_device(idx, dev)
                rows = waves[idx_d]
                done()
            with prof.time("filtered_waveforms.filter"):
                filtered = self._filter(rows, configs[hw], "device")
                done()
            with prof.time("filtered_waveforms.scatter"):
                out[idx_d] = filtered
                done()
        return out
