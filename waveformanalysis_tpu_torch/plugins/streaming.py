"""Chunked streaming execution: StreamingPlugin and StreamingContext.

Behavioral analog of the reference streaming engine
(reference: waveform_analysis/core/plugins/core/streaming.py:119-1229):

- streaming_config keys: chunk_size, parallel, executor_type, max_workers,
  parallel_batch_size, break_threshold_ps, required_halo_ns (or _left/_right),
  clip_strict, executor_config;
- static inputs convert to chunks with break segmentation (gaps >
  break_threshold_ps start a new segment) and halo extension so windowed
  kernels see neighbors;
- per-chunk compute -> output clipped back to the main window -> boundary
  validation;
- stateful plugins run serial with ``reset_state()`` at segment breaks;
- parallel chunks run in ordered batches with fail-fast cancellation and a
  pickle probe before process pools.

Port of ``waveformanalysis_tpu/plugins/streaming.py``. Chunk compute is a
device stage launched from the host, so "parallel" pipelines host prep
against device execution (threads suffice: the kernels release the GIL).
``executor_type="device"`` runs each chunk's device stage on a device:
groups of chunks spread over the Context's mesh, one chunk a device, or
one chunk at a time on the Context's device with no mesh attached.
``merge_stream(backend="device")`` sorts on a mesh (``parallel/``).
"""

from __future__ import annotations

import abc
import logging
from concurrent.futures import FIRST_EXCEPTION, wait
from dataclasses import dataclass
from typing import Any, Dict, Generator, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from waveformanalysis_tpu_torch.device import on_device, to_device, to_numpy
from waveformanalysis_tpu_torch.dtypes import chunk as C
from waveformanalysis_tpu_torch.dtypes.chunk import Chunk
from waveformanalysis_tpu_torch.execution.manager import get_executor, is_picklable
from waveformanalysis_tpu_torch.foundation.exceptions import ValidationError
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin

logger = logging.getLogger(__name__)

DEFAULT_STREAM_CHUNK_SIZE = 50_000

STREAMING_CONFIG_KEYS = (
    "chunk_size",
    "parallel",
    "executor_type",
    "max_workers",
    "parallel_batch_size",
    "break_threshold_ps",
    "required_halo_ns",
    "required_halo_left_ns",
    "required_halo_right_ns",
    "clip_strict",
    "executor_config",
)


@dataclass
class StreamingConfig:
    chunk_size: int = DEFAULT_STREAM_CHUNK_SIZE
    parallel: bool = False
    executor_type: str = "thread"
    max_workers: Optional[int] = None
    parallel_batch_size: Optional[int] = None
    break_threshold_ps: float = C.DEFAULT_BREAK_THRESHOLD_PS
    required_halo_left_ns: float = 0.0
    required_halo_right_ns: float = 0.0
    clip_strict: bool = False

    @classmethod
    def resolve(cls, context: Any, plugin: Any,
                override: Optional[Dict[str, Any]] = None) -> "StreamingConfig":
        """Read streaming_config from plugin options / context config.

        ``override`` merges over the configured dict — per-call knobs from
        ``StreamingContext.get_stream`` (reference parity: its get_stream
        forwards streaming_config to plugin.compute, streaming.py:1003-1018).
        """
        raw: Dict[str, Any] = {}
        if "streaming_config" in getattr(plugin, "options", {}):
            raw = dict(context.get_config(plugin, "streaming_config") or {})
        if override:
            raw.update(override)
        halo = raw.get("required_halo_ns")
        left = raw.get("required_halo_left_ns", halo or 0.0)
        right = raw.get("required_halo_right_ns", halo or 0.0)
        return cls(
            chunk_size=int(raw.get("chunk_size", DEFAULT_STREAM_CHUNK_SIZE)),
            parallel=bool(raw.get("parallel", False)),
            executor_type=str(raw.get("executor_type", "thread")),
            max_workers=raw.get("max_workers"),
            parallel_batch_size=raw.get("parallel_batch_size"),
            break_threshold_ps=float(
                raw.get("break_threshold_ps", C.DEFAULT_BREAK_THRESHOLD_PS)
            ),
            required_halo_left_ns=float(left or 0.0),
            required_halo_right_ns=float(right or 0.0),
            clip_strict=bool(raw.get("clip_strict", False)),
        )


class StreamingPlugin(Plugin):
    """Plugin computing over chunk iterators instead of whole arrays."""

    output_kind = "stream"
    is_stateful: bool = False
    # device chunk execution opt-in: subclasses implementing the
    # device_stream_config / device_chunk_inputs / device_chunk_stage /
    # device_chunk_finalize hooks can run streaming_config
    # executor_type="device": each chunk's inputs go up to the Context's
    # device (or a device of its mesh) and its stage runs there (the analog
    # of the reference's chunk thread pool, reference:
    # waveform_analysis/core/plugins/core/streaming.py:740-880)
    device_parallel: bool = False
    options = {
        "streaming_config": Option(
            default=None, type=dict, track=False,
            help="Streaming knobs: chunk_size, parallel, halo, breaks, ...",
        ),
    }

    # -- subclass hooks ---------------------------------------------------------

    @abc.abstractmethod
    def compute_chunk(self, context: Any, run_id: str, chunk: Chunk) -> Any:
        """Process one chunk; returns data (Table/array) or a Chunk."""

    def reset_state(self) -> None:
        """Called at segment breaks for stateful plugins."""

    def input_stream(
        self, context: Any, run_id: str, cfg: StreamingConfig
    ) -> Iterator[Chunk]:
        """Default input: the first dependency converted to chunks."""
        deps = self.resolve_depends_on(context, run_id) or list(self.depends_on)
        if not deps:
            raise ValueError(
                f"StreamingPlugin {self.provides} has no dependencies to stream"
            )
        dep = self.get_dependency_name(deps[0])
        data = context.get_data(run_id, dep)
        yield from data_to_chunks(
            data, run_id=run_id, data_type=dep, cfg=cfg
        )

    # -- engine -------------------------------------------------------------------

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Generator:
        cfg = StreamingConfig.resolve(
            context, self, override=kwargs.get("streaming_config")
        )
        chunks = self.input_stream(context, run_id, cfg)

        if self.is_stateful and (cfg.parallel or cfg.executor_type == "device"):
            logger.warning(
                "%s is stateful; forcing serial streaming execution", self.provides
            )
        if cfg.executor_type == "device":
            if self.device_parallel and not self.is_stateful:
                return self._compute_device(context, run_id, chunks, cfg)
            if not self.is_stateful:
                logger.warning(
                    "%s has no device-parallel hooks; falling back to %s",
                    self.provides, "thread pool" if cfg.parallel else "serial",
                )
            cfg.executor_type = "thread"
        if cfg.parallel and not self.is_stateful:
            return self._compute_parallel(context, run_id, chunks, cfg)
        return self._compute_serial(context, run_id, chunks, cfg)

    def _compute_serial(
        self, context: Any, run_id: str, chunks: Iterator[Chunk], cfg: StreamingConfig
    ) -> Generator:
        last_segment = None
        for chunk in chunks:
            segment = chunk.metadata.get("segment_id")
            if self.is_stateful and segment != last_segment:
                self.reset_state()
                last_segment = segment
            result = self.compute_chunk(context, run_id, chunk)
            out = self._postprocess_result(chunk, result, cfg)
            if out is not None:
                self._validate_chunk(out)
                yield out

    def _compute_parallel(
        self, context: Any, run_id: str, chunks: Iterator[Chunk], cfg: StreamingConfig
    ) -> Generator:
        executor_type = cfg.executor_type
        if executor_type == "process" and not is_picklable(self):
            logger.warning(
                "%s is not picklable; falling back to thread executor",
                self.provides,
            )
            executor_type = "thread"

        workers = cfg.max_workers or 4
        batch_size = cfg.parallel_batch_size or max(10, workers * 3)

        def worker(chunk: Chunk) -> Tuple[Chunk, Any]:
            return chunk, self.compute_chunk(context, run_id, chunk)

        chunk_iter = iter(chunks)
        with get_executor(
            f"streaming.{self.provides}", executor_type=executor_type,
            max_workers=workers,
        ) as pool:
            while True:
                batch = []
                for chunk in chunk_iter:
                    batch.append(chunk)
                    if len(batch) >= batch_size:
                        break
                if not batch:
                    break
                futures = [pool.submit(worker, ch) for ch in batch]
                done, pending = wait(futures, return_when=FIRST_EXCEPTION)
                failed = next(
                    (f for f in done if f.exception() is not None), None
                )
                if failed is not None:
                    for f in pending:
                        f.cancel()
                    raise failed.exception()
                # ordered yield (futures list preserves submission order)
                for f in futures:
                    chunk, result = f.result()
                    out = self._postprocess_result(chunk, result, cfg)
                    if out is not None:
                        self._validate_chunk(out)
                        yield out

    # -- device-parallel chunk execution -------------------------------------------

    # subclass hooks (see device_parallel). device_chunk_stage must be a
    # STATIC function of tensors on one device: rows are independent, so
    # per-row outputs cannot depend on the batch shape — the parity contract
    # the chunk-invariance tests enforce.
    def device_stream_config(self, context: Any) -> dict:  # pragma: no cover
        raise NotImplementedError

    def device_chunk_inputs(
        self, context: Any, run_id: str, chunk: Chunk
    ) -> Dict[str, Any]:  # pragma: no cover
        raise NotImplementedError

    @staticmethod
    def device_chunk_stage(cfg: dict, inputs: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError  # pragma: no cover

    def device_chunk_finalize(
        self, context: Any, run_id: str, chunk: Chunk, stage_out: Dict[str, Any]
    ) -> Any:  # pragma: no cover
        raise NotImplementedError

    def _compute_device(
        self, context: Any, run_id: str, chunks: Iterator[Chunk],
        cfg: StreamingConfig,
    ) -> Generator:
        """Device chunk executor: each group of ``n_shards`` chunks runs one
        chunk on each device of the Context's mesh, their finalize on the
        host, in chunk order.

        This is the production device path for the chunked streaming runtime
        (reference thread-pool analog: streaming.py:740-880): chunk windows,
        halo rows, break segmentation, main-window clipping and boundary
        validation are EXACTLY the host engine's (chunks come from the same
        data_to_chunks), only the per-chunk compute moves to the devices.
        With no mesh attached a group is one chunk on the Context's device.
        No row is padded: each stage's tensors are its chunk's own (a chunk
        of no rows launches nothing and yields empty). A kernel's build or
        launch failure propagates.
        """
        mesh_info = context.mesh
        devs = ([context.device] if mesh_info is None
                else mesh_info[0].shard_devices(mesh_info[1]))
        kernel_cfg = self.device_stream_config(context)
        stage = type(self).device_chunk_stage
        timed = context.profiler.time
        chunk_iter = iter(chunks)
        while True:
            # host-clock phases: "chunks" is the input stream's own work
            # (the first chunk's includes the load and time sort of the
            # input), "fetch" waits for the stages' device work
            with timed("stream.device.chunks"):
                group = [c for _, c in zip(devs, chunk_iter)]
            if not group:
                return
            with timed("stream.device.inputs"):
                inputs = [self.device_chunk_inputs(context, run_id, c) for c in group]
            with timed("stream.device.upload"):
                dev_inputs = [{k: to_device(v, dev) for k, v in d.items()}
                              for d, dev in zip(inputs, devs)]
            with timed("stream.device.stage"):
                outs = []
                for d, dev in zip(dev_inputs, devs):
                    with on_device(dev):
                        outs.append(stage(kernel_cfg, d))
            with timed("stream.device.fetch"):
                host_outs = [{k: to_numpy(v) for k, v in o.items()} for o in outs]
            del dev_inputs, outs  # the device tensors go before a chunk is yielded
            for chunk, host_out in zip(group, host_outs):
                with timed("stream.device.finalize"):
                    result = self.device_chunk_finalize(context, run_id, chunk, host_out)
                    done = self._postprocess_result(chunk, result, cfg)
                    if done is not None:
                        self._validate_chunk(done)
                if done is not None:
                    yield done

    # -- post-processing -----------------------------------------------------------

    def _postprocess_result(
        self, in_chunk: Chunk, result: Any, cfg: StreamingConfig
    ) -> Optional[Chunk]:
        """Clip results back to the chunk's main (halo-free) window."""
        if result is None:
            return None
        if isinstance(result, Chunk):
            data = result.data
        else:
            data = result
        main_start = in_chunk.metadata.get("main_start", in_chunk.start)
        main_end = in_chunk.metadata.get("main_end", in_chunk.end)
        if C._nrows(data) > 0:
            data = C.select_time_range(
                data, start=main_start, end=main_end, strict=cfg.clip_strict,
                time_field=in_chunk.time_field,
            )
        return Chunk(
            data,
            start=main_start,
            end=main_end,
            run_id=in_chunk.run_id,
            data_type=self.provides,
            data_kind=in_chunk.data_kind,
            time_field=in_chunk.time_field,
            dt_field=in_chunk.dt_field,
            length_field=in_chunk.length_field,
            endtime_field=in_chunk.endtime_field,
            dt=in_chunk.dt,
            metadata=dict(in_chunk.metadata),
        )

    def _validate_chunk(self, chunk: Chunk) -> None:
        result = C.check_chunk_boundaries(
            chunk.data, chunk.start, chunk.end, time_field=chunk.time_field,
        )
        if not result.is_valid:
            raise ValidationError(
                f"{self.provides}: chunk boundary violation: {result.errors}"
            )


def data_to_chunks(
    data: Any,
    run_id: str,
    data_type: str,
    cfg: StreamingConfig,
    time_field: str = C.TIME_FIELD,
) -> Iterator[Chunk]:
    """Static table/array -> chunk stream with break segmentation + halo.

    (reference: streaming.py:592-738 _data_to_chunks + _iter_segments)
    """
    if C._nrows(data) == 0:
        return
    if not C.is_sorted_by_time(data, time_field):
        data = C.sort_by_time(data, time_field)

    tf = C.resolve_time_field(data, time_field)
    halo_left_ps = cfg.required_halo_left_ns * 1e3
    halo_right_ps = cfg.required_halo_right_ns * 1e3

    def endtimes_ps(d: Any) -> np.ndarray:
        """Endtimes in the time field's own unit. When the field is the ps
        ADC timestamp, dt (ns) scales by 1000 so chunk windows bound every
        derived output (e.g. hit global timestamps = ts + pos*dt*1000)."""
        t = C._col(d, tf).astype(np.int64)
        lf = C.resolve_length_field(d)
        if not C._has(d, lf) or not C._has(d, C.DT_FIELD):
            return t
        length = C._col(d, lf).astype(np.int64)
        dt_col = C._col(d, C.DT_FIELD).astype(np.int64)
        scale = 1000 if tf == C.TIMESTAMP_FIELD else 1
        return t + dt_col * scale * length

    segment_id = 0
    for seg_data, _info in C.split_by_breaks(
        data, break_threshold_ps=cfg.break_threshold_ps, time_field=time_field
    ):
        n = C._nrows(seg_data)
        times = C._col(seg_data, tf).astype(np.int64)
        seg_endtimes = endtimes_ps(seg_data)
        for lo in range(0, n, cfg.chunk_size):
            hi = min(lo + cfg.chunk_size, n)
            main_start = int(times[lo])
            main_end = int(seg_endtimes[lo:hi].max()) + 1
            # halo: pull in neighboring records intersecting the extended window
            sel_start = main_start - int(halo_left_ps)
            sel_end = main_end + int(halo_right_ps)
            if halo_left_ps or halo_right_ps:
                mask = (seg_endtimes > sel_start) & (times < sel_end)
                chunk_data = C._take(seg_data, mask)
                chunk_ends = seg_endtimes[mask]
            else:
                chunk_data = C._take(seg_data, slice(lo, hi))
                chunk_ends = seg_endtimes[lo:hi]
            if C._nrows(chunk_data):
                start = min(sel_start, int(C._col(chunk_data, tf).min()))
                end = max(sel_end, int(chunk_ends.max()) + 1)
            else:
                start, end = sel_start, sel_end
            yield Chunk(
                chunk_data,
                start=start,
                end=end,
                run_id=run_id,
                data_type=data_type,
                time_field=time_field,
                metadata={
                    "main_start": main_start,
                    "main_end": main_end,
                    "segment_id": segment_id,
                },
            )
        segment_id += 1


class _StaticWrapper(StreamingPlugin):
    """Wraps a static data name as a chunk stream
    (reference: streaming.py:977 get_stream static path)."""

    provides = "_static_stream"
    depends_on: List[str] = []

    def __init__(self, data_name: str) -> None:
        self.data_name = data_name
        self.provides = f"{data_name}_stream_view"
        self.depends_on = [data_name]

    def compute_chunk(self, context: Any, run_id: str, chunk: Chunk) -> Any:
        return chunk.data


class StreamingContext:
    """Streaming façade over a Context
    (reference: streaming.py:913-1229)."""

    def __init__(self, context: Any) -> None:
        self.ctx = context

    def get_stream(
        self,
        run_id: str,
        data_name: str,
        time_range: Optional[Tuple[int, int]] = None,
        chunk_size: Optional[int] = None,
        **streaming_overrides: Any,
    ) -> Iterator[Chunk]:
        """Chunk stream for a data name (stream plugins run natively; static
        data wraps into chunks)."""
        plugin = self.ctx.get_plugin(data_name)
        if plugin is not None and plugin.output_kind == "stream":
            # per-call knobs reach native stream plugins too (reference
            # parity: get_stream forwards streaming_config to
            # plugin.compute, streaming.py:1003-1018); without overrides
            # the plain get_data path keeps stats/validation in the loop
            overrides = dict(streaming_overrides)
            if chunk_size:
                overrides["chunk_size"] = chunk_size
            if overrides:
                stream = plugin.compute(self.ctx, run_id,
                                        streaming_config=overrides)
            else:
                stream = self.ctx.get_data(run_id, data_name)
        else:
            stream = self._static_stream(
                run_id, data_name, chunk_size, streaming_overrides
            )

        for chunk in stream:
            if time_range is not None:
                lo, hi = time_range
                if chunk.end <= lo or chunk.start >= hi:
                    continue
                clipped = C.select_time_range(
                    chunk.data, start=lo, end=hi, strict=False,
                    time_field=chunk.time_field,
                )
                chunk = Chunk(
                    clipped, start=max(chunk.start, lo), end=min(chunk.end, hi),
                    run_id=chunk.run_id, data_type=chunk.data_type,
                    time_field=chunk.time_field, metadata=dict(chunk.metadata),
                )
            yield chunk

    def _static_stream(
        self, run_id: str, data_name: str, chunk_size: Optional[int],
        streaming_overrides: Dict[str, Any],
    ) -> Iterator[Chunk]:
        """Static data as chunks. With ``executor_type="device"``, a static
        plugin whose compute maps onto the two-phase kernel interface gets
        DERIVED device hooks (plugins/device_stream.py) and each chunk's
        stage runs on the Context's device; a plain data name falls back to
        the host chunk view."""
        from waveformanalysis_tpu_torch.plugins.device_stream import (
            DeviceKernelStream,
        )

        wants_device = streaming_overrides.get("executor_type") == "device"
        adapter = (
            DeviceKernelStream.for_data_name(self.ctx, data_name)
            if wants_device else None
        )
        if wants_device and adapter is None:
            logger.warning(
                "get_stream(%s, executor_type='device'): no derivable "
                "device hooks for this name; serving the host chunk view",
                data_name,
            )
        wrapper = adapter if adapter is not None else _StaticWrapper(data_name)
        cfg = StreamingConfig.resolve(self.ctx, wrapper)
        if chunk_size:
            cfg.chunk_size = chunk_size
        for key, value in streaming_overrides.items():
            if hasattr(cfg, key):
                setattr(cfg, key, value)
        if adapter is not None:
            return adapter._compute_device(
                self.ctx, run_id,
                adapter.input_stream(self.ctx, run_id, cfg), cfg,
            )
        return wrapper._compute_serial(
            self.ctx, run_id, wrapper.input_stream(self.ctx, run_id, cfg), cfg
        )

    def merge_stream(
        self,
        stream: Iterable[Chunk],
        sort: bool = True,
        backend: str = "auto",
        mesh: Any = None,
    ) -> Any:
        """Materialize a chunk stream into one time-sorted table.

        backend:
          - ``host``: concat + stable host argsort (reference semantics,
            streaming.py:740-880 analog).
          - ``device``: shard the concatenated table over a mesh (``mesh``,
            else one over every CUDA device) and run the distributed block
            odd-even merge (parallel/sorted_merge.py).
          - ``auto``: device when a mesh with >1 device is supplied,
            host otherwise.
        """
        parts = [c.data for c in stream if len(c) > 0]
        if not parts:
            return np.array([])
        merged = C._concat(parts)
        if not sort:
            return merged
        use_device = backend == "device" or (
            backend == "auto" and mesh is not None and mesh.size > 1
        )
        if use_device:
            if mesh is None:
                from waveformanalysis_tpu_torch.parallel.mesh import make_mesh

                mesh = make_mesh()
            return self._merge_sorted_on_mesh(merged, mesh)
        return C.sort_by_time(merged)

    @staticmethod
    def _merge_sorted_on_mesh(merged: Any, mesh: Any) -> Any:
        """Distributed sort of a table by (time, record_id) on the mesh."""
        from waveformanalysis_tpu_torch.dtypes.table import Table
        from waveformanalysis_tpu_torch.parallel.sorted_merge import sharded_time_sort

        tf = C.resolve_time_field(merged, C.TIME_FIELD)
        if isinstance(merged, Table):
            cols = {k: to_numpy(v) for k, v in merged.columns.items()}
            names = merged.field_names
            schema = merged.schema
        elif isinstance(merged, np.ndarray) and merged.dtype.names:
            cols = {k: np.ascontiguousarray(merged[k]) for k in merged.dtype.names}
            names = merged.dtype.names
            schema = None
        else:
            return C.sort_by_time(merged)
        keys = [tf] + (["record_id"] if "record_id" in cols else [])
        out_cols = sharded_time_sort(cols, keys, mesh, pad_key=tf)
        if isinstance(merged, Table):
            return Table({k: out_cols[k] for k in names}, schema=schema,
                         validate=False)
        out = np.zeros(len(out_cols[tf]), dtype=merged.dtype)
        for k in names:
            out[k] = out_cols[k]
        return out


def get_streaming_context(context: Any) -> StreamingContext:
    return StreamingContext(context)
