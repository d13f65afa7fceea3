"""PyTorch/CUDA port of waveformanalysis_tpu.

Module paths mirror the JAX package (``ops/features.py`` here is the port
of ``waveformanalysis_tpu/ops/features.py``), and every public function
keeps the JAX package's event-major ``(n, L)`` layout, output keys and
dtypes. The package imports torch and numpy only, never jax. Device work
runs on CUDA unless the caller asks for the CPU.

Use it through this facade, ``import waveformanalysis_tpu_torch as wa``:
each facade name of the JAX package whose module is ported keeps its name
(``wa.ChainConfig``, ``wa.full_chain_step``, ``wa.Context``, ``wa.Table``,
...). The chain entries named after a kernel take the port's names:

==============================  ==========================================
JAX package                     port
==============================  ==========================================
``make_jit_chain``              ``make_chain`` (plain PyTorch)
``make_jit_chain_scan``         ``make_chain_scan`` (K1, ``csrc/chain_scan.cu``)
``chain_scan_pallas``           ``chain_scan_cuda``
``make_jit_chain_pallas``       ``make_chain_tile`` (K7, ``csrc/chain_tile.cu``)
``chain_pallas``                ``chain_tile_cuda``
``tpu_default``                 ``cuda_default`` (the default plugin profile)
==============================  ==========================================

``example_chain_batch`` and ``batch_from_numpy`` are on the facade too.
Names whose modules are not ported yet (the sharded chains, the plugin
loaders, previews and plotting utilities, ...) are absent: asking for one
raises ``AttributeError``.

Ported so far:

- slice 1, the standalone fused chain (features -> find_peaks -> threshold
  hits -> 10-90% widths -> S1/S2 label): ``make_chain_scan``, kernel K1;
- slice 2, the Context route ``Context.get_data(run, ["s1_s2",
  "hit_threshold"])``: the peaks, hit-run and width scan kernels K2-K4;
- slice 3, the same route through ``filtered_waveforms`` (SG, or the
  Butterworth bandpass through the zero-phase kernel K5 and its two-pass
  mode K6);
- slice 4, the tile-resident chain ``make_chain_tile`` (K7, one warp per
  event on the event-major rows) and the fused-chain demo
  (``python -m waveformanalysis_tpu_torch.examples.fused_chain_demo``);
- slice 8, the path from DAQ files: the VX2730 / V1725 adapters
  (``get_adapter``), ``raw_files`` -> ``st_waveforms`` -> ``df`` ->
  ``df_events`` / ``hit_grouped`` -> ``df_paired`` under the default
  profile (``ctx.register(*get_profile("cuda"))``), the event grouping
  (``group_multi_channel_hits``) and the tutorial
  (``python -m waveformanalysis_tpu_torch.examples.tutorial``);
- slice 9, records ingest: the records set (``records``, ``wave_pool``,
  ``wave_pool_filtered``) in the default profile, ``wave_source="records"``
  on the feature plugins, ``RecordsView`` and ``TimeRangeQueryEngine``,
  and the V1725 device unpack (``st_waveforms.device_unpack=True``);
- slice 10, multi-run batching: ``Context.get_data_batched(runs, names)``
  runs every run's fused bundle as one concatenated device program per
  device configuration (K2-K4 launch once per group, not once per run),
  with ``BatchProcessor`` (thread, process and ``device`` executors) and
  the host execution helpers (``ExecutorManager``, ``parallel_map``, ...;
  process pools ``spawn`` their workers), and the sticky slot-capacity
  hints of the single-run program; the demo
  ``python -m waveformanalysis_tpu_torch.examples.batched_multirun_demo``;
- slice 11, chunked streaming: ``Chunk`` and its time algebra,
  ``StreamingPlugin`` / ``StreamingContext`` (``get_streaming_context``),
  the device chunk executor derived from the static plugins' own stages
  (``get_stream(run, "hit", executor_type="device")`` launches K2 once per
  chunk, ``hit_threshold`` K3) and ``signal_peaks_stream`` in
  ``get_profile("streaming")``; the demo
  ``python -m waveformanalysis_tpu_torch.examples.streaming_demo``;
- slice 12, the surface users start from: ``python -m
  waveformanalysis_tpu_torch.cli`` (``waveform-process``), ``.cli_cache``
  (``waveform-cache``), ``.utils.cli_docs`` (``waveform-docs``) and
  ``.server`` (``waveform-serve``, ``PipelineServer``: one warm Context
  answering ``get_data`` / ``get_data_batched`` over a unix socket), with
  the cache suite (``storage/cache_ops.py``, ``CacheManager``), the export
  (``DataExporter``), the dependency analysis (``DependencyAnalyzer``), the
  lineage graph (``build_lineage_graph``) and the DAQ inspection
  (``DAQRun``, ``DAQAnalyzer``).
"""

from __future__ import annotations

import importlib
from typing import Any

__version__ = "0.1.0"

_P = "waveformanalysis_tpu_torch."

# name -> (module, attribute)
_LAZY_API = {
    # dtypes / data model
    "Table": (_P + "dtypes.table", "Table"),
    "Schema": (_P + "dtypes.schema", "Schema"),
    "ST_WAVEFORM_DTYPE": (_P + "dtypes.schema", "ST_WAVEFORM_DTYPE"),
    "RECORDS_DTYPE": (_P + "dtypes.schema", "RECORDS_DTYPE"),
    "create_record_dtype": (_P + "dtypes.schema", "create_record_dtype"),
    "Chunk": (_P + "dtypes.chunk", "Chunk"),
    # plugin system
    "Plugin": (_P + "plugins.base", "Plugin"),
    "Option": (_P + "plugins.base", "Option"),
    "option": (_P + "plugins.base", "option"),
    "takes_config": (_P + "plugins.base", "takes_config"),
    "PluginSpec": (_P + "plugins.spec", "PluginSpec"),
    "StreamingPlugin": (_P + "plugins.streaming", "StreamingPlugin"),
    "StreamingContext": (_P + "plugins.streaming", "StreamingContext"),
    "get_streaming_context": (_P + "plugins.streaming", "get_streaming_context"),
    # context / storage
    "Context": (_P + "context.context", "Context"),
    "MemmapStorage": (_P + "storage.memmap", "MemmapStorage"),
    "SQLiteBackend": (_P + "storage.backends", "SQLiteBackend"),
    "StorageBackend": (_P + "storage.backends", "StorageBackend"),
    "CompressionManager": (_P + "storage.compression", "CompressionManager"),
    "IntegrityChecker": (_P + "storage.integrity", "IntegrityChecker"),
    "ErrorContext": (_P + "foundation.exceptions", "ErrorContext"),
    "make_fake_st_waveforms": (_P + "testing.fixtures", "make_fake_st_waveforms"),
    "make_tiny_context": (_P + "testing.fixtures", "make_tiny_context"),
    # the fused chain
    "ChainConfig": (_P + "models.full_chain", "ChainConfig"),
    "full_chain_step": (_P + "models.full_chain", "full_chain_step"),
    "make_chain": (_P + "models.full_chain", "make_chain"),
    "example_chain_batch": (_P + "models.full_chain", "example_chain_batch"),
    "batch_from_numpy": (_P + "models.full_chain", "batch_from_numpy"),
    "make_chain_scan": (_P + "ops.chain_scan_cuda", "make_chain_scan"),
    "chain_scan_cuda": (_P + "ops.chain_scan_cuda", "chain_scan_cuda"),
    "find_peaks_scan": (_P + "ops.chain_scan_cuda", "find_peaks_scan"),
    "make_chain_tile": (_P + "ops.chain_tile_cuda", "make_chain_tile"),
    "chain_tile_cuda": (_P + "ops.chain_tile_cuda", "chain_tile_cuda"),
    # ingest, profiles and event grouping
    "get_adapter": (_P + "formats.adapter", "get_adapter"),
    "register_adapter": (_P + "formats.adapter", "register_adapter"),
    "list_adapters": (_P + "formats.adapter", "list_adapters"),
    "WaveformStruct": (_P + "plugins.builtin.waveforms", "WaveformStruct"),
    "WaveformStructConfig": (_P + "plugins.builtin.waveforms", "WaveformStructConfig"),
    "cuda_default": (_P + "plugins.plugin_sets", "cuda_default"),
    "get_profile": (_P + "plugins.plugin_sets", "get_profile"),
    "group_multi_channel_hits": (_P + "ops.grouping", "group_multi_channel_hits"),
    # records
    "RecordsView": (_P + "data.records_view", "RecordsView"),
    "TimeRangeQueryEngine": (_P + "data.query", "TimeRangeQueryEngine"),
    # multi-run batching and host execution
    "BatchProcessor": (_P + "data.batch_processor", "BatchProcessor"),
    "CancellationToken": (_P + "execution.cancellation", "CancellationToken"),
    "ExecutorManager": (_P + "execution.manager", "ExecutorManager"),
    "EXECUTOR_CONFIGS": (_P + "execution.manager", "EXECUTOR_CONFIGS"),
    "get_executor": (_P + "execution.manager", "get_executor"),
    "get_executor_manager": (_P + "execution.manager", "get_executor_manager"),
    "get_config": (_P + "execution.manager", "get_config"),
    "register_config": (_P + "execution.manager", "register_config"),
    "parallel_map": (_P + "execution.manager", "parallel_map"),
    "parallel_apply": (_P + "execution.manager", "parallel_apply"),
    "get_timeout_manager": (_P + "execution.timeout", "get_timeout_manager"),
    # the surface: server, export, analysis, DAQ inspection, lineage
    "PipelineServer": (_P + "server", "PipelineServer"),
    "DataExporter": (_P + "data.export", "DataExporter"),
    "DependencyAnalyzer": (_P + "data.dependency_analysis", "DependencyAnalyzer"),
    "CacheManager": (_P + "storage.function_cache", "CacheManager"),
    "DAQRun": (_P + "utils.daq", "DAQRun"),
    "DAQAnalyzer": (_P + "utils.daq", "DAQAnalyzer"),
    "LineageGraphModel": (_P + "foundation.model", "LineageGraphModel"),
    "build_lineage_graph": (_P + "foundation.model", "build_lineage_graph"),
    # foundation
    "Profiler": (_P + "foundation.profiler", "Profiler"),
    "OneTimeGenerator": (_P + "foundation.utils", "OneTimeGenerator"),
    "ProgressTracker": (_P + "foundation.progress", "ProgressTracker"),
    "ErrorSeverity": (_P + "foundation.exceptions", "ErrorSeverity"),
    "PluginError": (_P + "foundation.exceptions", "PluginError"),
    "StandardUnits": (_P + "foundation.units", "StandardUnits"),
    "convert_time": (_P + "foundation.units", "convert_time"),
}

__all__ = sorted(_LAZY_API) + ["__version__"]


def __getattr__(name: str) -> Any:
    try:
        module_name, attr = _LAZY_API[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module_name), attr)
    globals()[name] = value
    return value


def __dir__():
    return __all__
