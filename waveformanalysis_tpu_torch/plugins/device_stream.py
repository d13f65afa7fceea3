"""Generic device chunk-streaming for static wave-chain plugins.

Port of ``waveformanalysis_tpu/plugins/device_stream.py``. The chunk
executor (``StreamingPlugin._compute_device``) needs four
``device_chunk_*`` hooks; any STATIC plugin that already exposes the fused
executor's two-phase interface — ``kernel_config`` + ``device_stage`` on
tensors + host ``finalize`` — gets them DERIVED here (reference genericity
bar: the chunk executor at
waveform_analysis/core/plugins/core/streaming.py:740-880 is generic over
every StreamingPlugin), so ``StreamingContext.get_stream(run, <static
name>, executor_type="device")`` streams on the Context's device (or its
mesh, a chunk on each device) with no per-plugin code.

Derivation per chunk:

- inputs: the same flat-table extraction the fused bundle uses
  (waves / lengths / sign / baselines from the chunk's rows; per-channel
  thresholds via the plugin's ``host_prep`` when it has one), uploaded to
  ``context.device``;
- stage: the plugin's own ``device_stage`` restricted to its device-config
  keys (the host-only keys — dt, channel_config, overflow_policy — stay
  host-side). On a CUDA device ``hit`` launches the find_peaks kernel (K2)
  and ``hit_threshold`` the threshold-run kernel (K3) once per chunk;
- finalize: the plugin's own ``finalize`` over the chunk rows' metadata,
  with ``event_index`` rewritten to the rows' ``record_id`` so identities
  stay global across chunks (a chunk-local arange would collide).

Because stage and finalize are the plugin's own, every row is numerically
identical to the standalone compute; the chunk-invariance tests in
tests/test_torch_device_stream.py pin device-executor output chunk-for-chunk
against the host serial engine.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np

from waveformanalysis_tpu_torch.device import to_device, to_numpy
from waveformanalysis_tpu_torch.dtypes.chunk import Chunk
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.plugins.streaming import StreamingPlugin

logger = logging.getLogger(__name__)


def _chunk_table(chunk: Chunk) -> Table:
    data = chunk.data
    if not isinstance(data, Table):
        data = Table.from_numpy(data)
    return data


def _host(data: Table, name: str) -> np.ndarray:
    return to_numpy(data[name])


def _wave_meta(data: Table):
    """(waves, lengths, meta) from a chunk's structured rows — the same
    extraction as the standalone plugins' flat path
    (plugins/builtin/peak_finding.py _load_wave_matrix). The wave column
    stays where it is (a tensor passes through); the metadata is read on
    the host."""
    from waveformanalysis_tpu_torch.plugins.builtin._wave_source import (
        wave_matrix_view,
    )

    n = len(data)
    waves = wave_matrix_view(data["wave"])
    lengths = (
        np.asarray(_host(data, "event_length"), dtype=np.int64)
        if "event_length" in data
        else np.full(n, waves.shape[1], dtype=np.int64)
    )
    meta = {
        "baseline": np.asarray(_host(data, "baseline"), dtype=np.float64)
        if "baseline" in data else np.zeros(n),
        "polarity": np.asarray(_host(data, "polarity"), dtype=np.int8)
        if "polarity" in data else np.full(n, -1, np.int8),
        "timestamp": np.asarray(_host(data, "timestamp"), dtype=np.int64)
        if "timestamp" in data else np.zeros(n, np.int64),
        "board": np.asarray(_host(data, "board"), dtype=np.int16)
        if "board" in data else np.zeros(n, np.int16),
        "channel": np.asarray(_host(data, "channel"), dtype=np.int16)
        if "channel" in data else np.zeros(n, np.int16),
        "record_id": np.asarray(_host(data, "record_id"), dtype=np.int64)
        if "record_id" in data else np.arange(n, dtype=np.int64),
        "dt": np.asarray(_host(data, "dt"), dtype=np.int64)
        if "dt" in data else None,
    }
    return waves, lengths, meta


@dataclass(frozen=True)
class _Glue:
    """Per-data-name derivation spec."""

    # device-config keys forwarded to device_stage
    device_cfg_keys: tuple
    # stage(cfg, inputs) -> per-row outputs (rows independent of batch)
    stage: Callable[[dict, Dict[str, Any]], Dict[str, Any]]
    # finalize(plugin, full_cfg, stage_out, meta, lengths, n) -> Table
    finalize: Callable[..., Any]
    needs_thresholds: bool = False


def _bf_stage(cfg: dict, inputs: Dict[str, Any]) -> Dict[str, Any]:
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import (
        BasicFeaturesPlugin,
    )

    return BasicFeaturesPlugin.device_stage(
        cfg, inputs["waves"], inputs["lengths"]
    )


def _bf_finalize(plugin, context, run_id, cfg, stage_out, meta, lengths, n):
    bf_baselines = plugin.host_prep(
        cfg, context, run_id,
        np.asarray(meta["baseline"], dtype=np.float64),
        meta["board"], meta["channel"],
    )
    table = plugin.finalize(
        cfg, {k: to_numpy(v) for k, v in stage_out.items()},
        bf_baselines, meta["polarity"], meta["timestamp"], meta["board"],
        meta["channel"],
    )
    # global identity: chunk-local arange would collide across chunks
    table["event_index"] = meta["record_id"].astype(np.int64)
    return table


def _hit_stage(cfg: dict, inputs: Dict[str, Any]) -> Dict[str, Any]:
    from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import (
        HitFinderPlugin,
    )

    return HitFinderPlugin.device_stage(
        cfg, inputs["waves"], inputs["lengths"], inputs["sign"],
        inputs["baselines"],
    )


def _hit_finalize(plugin, context, run_id, cfg, stage_out, meta, lengths, n):
    return plugin.finalize(
        cfg, {k: to_numpy(v) for k, v in stage_out.items()}, meta, n
    )


def _ht_stage(cfg: dict, inputs: Dict[str, Any]) -> Dict[str, Any]:
    from waveformanalysis_tpu_torch.plugins.builtin.hit_finder import (
        ThresholdHitPlugin,
    )

    return ThresholdHitPlugin.device_stage(
        cfg, inputs["waves"], inputs["lengths"], inputs["sign"],
        inputs["baselines"], inputs["thresholds"],
    )


def _ht_finalize(plugin, context, run_id, cfg, stage_out, meta, lengths, n):
    return plugin.finalize(
        cfg, {k: to_numpy(v) for k, v in stage_out.items()}, meta,
        np.asarray(lengths, dtype=np.int64), n,
    )


def _wwi_stage(cfg: dict, inputs: Dict[str, Any]) -> Dict[str, Any]:
    from waveformanalysis_tpu_torch.plugins.builtin.waveform_width_integral import (
        WaveformWidthIntegralPlugin,
    )

    return WaveformWidthIntegralPlugin.device_stage(
        cfg, inputs["waves"], inputs["lengths"], inputs["sign"],
        inputs["baselines"],
    )


def _wwi_finalize(plugin, context, run_id, cfg, stage_out, meta, lengths, n):
    table = plugin.finalize(
        cfg, {k: to_numpy(v) for k, v in stage_out.items()}, meta, n
    )
    table["event_index"] = meta["record_id"].astype(np.int64)
    return table


# data names with derivable device hooks. Keys into _DEVICE_CFG_KEYS-style
# subsets mirror context/fusion.py (host-only keys stay host-side).
DEVICE_STREAM_GLUE: Dict[str, _Glue] = {
    "basic_features": _Glue(
        device_cfg_keys=("height_range", "area_range"),
        stage=_bf_stage, finalize=_bf_finalize,
    ),
    "hit": _Glue(
        device_cfg_keys=(
            "use_derivative", "height", "distance", "prominence", "width",
            "height_method", "height_window_extension", "max_peaks",
            "backend",
        ),
        stage=_hit_stage, finalize=_hit_finalize,
    ),
    "hit_threshold": _Glue(
        device_cfg_keys=(
            "left_extension", "right_extension", "max_hits", "backend",
        ),
        stage=_ht_stage, finalize=_ht_finalize, needs_thresholds=True,
    ),
    "waveform_width_integral": _Glue(
        device_cfg_keys=("q_low", "q_high"),
        stage=_wwi_stage, finalize=_wwi_finalize,
    ),
}


class DeviceKernelStream(StreamingPlugin):
    """Chunked streaming adapter derived from a static plugin's kernels."""

    device_parallel = True
    save_when = "never"
    depends_on: list = []

    # one concrete subclass per adapted data name (device_chunk_stage must
    # be a static method of the class)
    _classes: Dict[str, type] = {}

    def __init__(self, data_name: str, inner: Any) -> None:
        self._data_name = data_name
        self._inner = inner
        self._glue = DEVICE_STREAM_GLUE[data_name]
        self.provides = f"{data_name}_device_stream"
        self.output_dtype = getattr(inner, "output_dtype", None)
        self._full_cfg_cache: Optional[dict] = None

    @classmethod
    def for_data_name(cls, context: Any, data_name: str):
        """Adapter instance, or None when the name has no derivable hooks
        (unknown name, overridden compute, or missing two-phase methods)."""
        glue = DEVICE_STREAM_GLUE.get(data_name)
        inner = getattr(context, "_plugins", {}).get(data_name)
        if glue is None or inner is None:
            return None
        for method in ("kernel_config", "device_stage", "finalize"):
            if not hasattr(inner, method):
                return None
        sub = cls._classes.get(data_name)
        if sub is None:
            glue_stage = glue.stage

            def stage(cfg: dict, inputs: Dict[str, Any]) -> Dict[str, Any]:
                return glue_stage(cfg, inputs)

            sub = type(
                f"DeviceKernelStream_{data_name}",
                (cls,),
                {"device_chunk_stage": staticmethod(stage)},
            )
            cls._classes[data_name] = sub
        return sub(data_name, inner)

    # -- streaming input: the inner plugin's wave source ----------------------

    def resolve_depends_on(self, context: Any, run_id: Optional[str] = None):
        from waveformanalysis_tpu_torch.plugins.builtin._wave_source import (
            resolve_wave_input_spec,
        )

        return list(resolve_wave_input_spec(context, self._inner).depends_on)

    def input_stream(self, context: Any, run_id: str, cfg):
        from waveformanalysis_tpu_torch.plugins.streaming import data_to_chunks

        deps = self.resolve_depends_on(context, run_id)
        data = context.get_data(run_id, deps[0])
        yield from data_to_chunks(
            data, run_id=run_id, data_type=deps[0], cfg=cfg
        )

    # -- derived device hooks -------------------------------------------------

    def _full_cfg(self, context: Any) -> dict:
        if self._full_cfg_cache is None:
            self._full_cfg_cache = self._inner.kernel_config(context)
        return self._full_cfg_cache

    def device_stream_config(self, context: Any) -> dict:
        full = self._full_cfg(context)
        return {k: full[k] for k in self._glue.device_cfg_keys}

    def device_chunk_inputs(
        self, context: Any, run_id: str, chunk: Chunk
    ) -> Dict[str, Any]:
        data = _chunk_table(chunk)
        waves, lengths, meta = _wave_meta(data)
        if isinstance(waves, np.ndarray):
            waves = np.ascontiguousarray(waves)
        inputs = {
            "waves": waves,
            "lengths": lengths.astype(np.int32),
            "sign": np.where(meta["polarity"] > 0, 1.0, -1.0).astype(
                np.float32
            ),
            "baselines": meta["baseline"].astype(np.float32),
        }
        if self._glue.needs_thresholds:
            inputs["thresholds"] = self._inner.host_prep(
                self._full_cfg(context), context, run_id, meta
            ).astype(np.float32)
        return inputs

    def device_chunk_finalize(
        self, context: Any, run_id: str, chunk: Chunk, stage_out: Dict
    ) -> Any:
        data = _chunk_table(chunk)
        _waves, lengths, meta = _wave_meta(data)
        return self._glue.finalize(
            self._inner, context, run_id, self._full_cfg(context),
            stage_out, meta, lengths, len(data),
        )

    def _empty_output(self) -> Table:
        """Zero-row output table in the inner plugin's schema (covers both
        Schema and numpy-dtype output declarations)."""
        from waveformanalysis_tpu_torch.dtypes.schema import Schema

        dtype = self.output_dtype
        if isinstance(dtype, Schema):
            return Table.zeros(0, dtype)
        return Table.from_numpy(np.zeros(0, dtype=np.dtype(dtype)))

    # -- the host engines' path: the same three phases, chunk by chunk --------

    def compute_chunk(self, context: Any, run_id: str, chunk: Chunk) -> Any:
        data = _chunk_table(chunk)
        if len(data) == 0:
            return self._empty_output()
        cfg = self.device_stream_config(context)
        inputs = self.device_chunk_inputs(context, run_id, chunk)
        out = type(self).device_chunk_stage(
            cfg, {k: to_device(v, context.device) for k, v in inputs.items()}
        )
        return self.device_chunk_finalize(context, run_id, chunk, out)
