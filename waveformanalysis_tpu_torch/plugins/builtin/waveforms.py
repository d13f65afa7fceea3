"""raw_files and st_waveforms plugins.

Behavioral analog of the reference waveform plugins
(reference: waveform_analysis/core/plugins/builtin/cpu/waveforms.py:922,971):

- RawFileNamesPlugin scans the run directory via the configured DAQ adapter
  and returns per-channel ordered file lists;
- WaveformsPlugin parses all raw files (file-level thread parallel) and
  structures them into one flat Table with the reference's exact semantics:
  baseline = mean of the baseline window (float64), timestamps normalized to
  ps, channel mapping via lookup table, polarity from channel metadata,
  sequential record_id after per-channel concatenation.

Port of ``waveformanalysis_tpu/plugins/builtin/waveforms.py``: the parse
and structuring run on the host in the threaded per-file flat parse,
``streaming_mode`` and the V1725 host walk; with ``device_unpack=True`` a
V1725 run's samples unpack on the Context's device (ops/v1725_device.py).
The options' help strings are the JAX package's, word for word: they feed
the plugin spec hash, so the cache keys match the JAX package's
(``device_unpack``'s still names the JAX build's jitted gather; the port's
is a torch gather on the Context's device).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from waveformanalysis_tpu_torch.dtypes.schema import (
    POLARITY_CODES,
    ST_WAVEFORM_SCHEMA,
)
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.hardware import (
    get_polarity,
    group_indices_by_hardware_channel,
)
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin
from waveformanalysis_tpu_torch.processing.loader import get_raw_files
from waveformanalysis_tpu_torch.processing.records_builder import resolve_baseline_window

logger = logging.getLogger(__name__)


class RawFileNamesPlugin(Plugin):
    """Scan the data directory and group raw files by channel."""

    provides = "raw_files"
    description = "Scan the data directory and group raw files by channel number."
    version = "0.0.2"
    save_when = "never"
    options = {
        "data_root": Option(default="DAQ", type=str, help="Root directory for data"),
        "daq_adapter": Option(default="vx2730", type=str, help="DAQ adapter name"),
    }

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> List[List[str]]:
        data_root = context.get_config(self, "data_root")
        daq_adapter = context.get_config(self, "daq_adapter")
        daq_run = getattr(context, "daq_run", None)
        return get_raw_files(
            run_name=run_id,
            data_root=data_root,
            daq_run=daq_run,
            daq_adapter=daq_adapter,
            n_channels=context.config.get("n_channels"),
            start_channel=context.config.get("start_channel", 0),
        )


def structure_channel_array(
    raw_arr: np.ndarray,
    spec: Any,
    dt_ns: int,
    wave_length: int,
    baseline_samples: Any = None,
    channel_idx: int = 0,
    channel_mapping: Optional[Dict[Tuple[int, int], int]] = None,
    upstream_baseline: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Structure one channel's raw 2-D array into column arrays.

    Numeric semantics match the reference structurer
    (waveforms.py:644-799): baseline window mean in float64, channel-mapping
    lookup table, ps-normalized timestamps, waves truncated/padded to
    wave_length with event_length = actual sample count.
    """
    cols = spec.columns
    n = len(raw_arr)

    boards = raw_arr[:, cols.board].astype(np.int16)
    channels = raw_arr[:, cols.channel].astype(np.int16)
    if channel_mapping:
        max_b = int(boards.max()) + 1
        max_c = int(channels.max()) + 1
        lut = np.full((max_b, max_c), -1, dtype=np.int16)
        for (b, c), phys in channel_mapping.items():
            if b < max_b and c < max_c:
                lut[b, c] = phys
        physical = lut[boards, channels]
        if np.any(physical == -1):
            unmapped = set(zip(boards[physical == -1].tolist(),
                               channels[physical == -1].tolist()))
            logger.warning("Unmapped (board, channel) combinations: %s", unmapped)
        channels = physical

    b_start, b_end = resolve_baseline_window(
        baseline_samples, cols.samples_start, cols.baseline_start, cols.baseline_end
    )
    b_end = min(b_end, raw_arr.shape[1])
    if b_end <= b_start:
        baselines = np.full(n, np.nan, dtype=np.float64)
    else:
        baselines = np.mean(raw_arr[:, b_start:b_end].astype(np.float64), axis=1)

    timestamps = spec.normalize_timestamp_to_ps(
        raw_arr[:, cols.timestamp].astype(np.int64), dt_ns=int(dt_ns)
    ).astype(np.int64)

    samples_end = cols.samples_end if cols.samples_end is not None else raw_arr.shape[1]
    samples_end = min(samples_end, raw_arr.shape[1])
    if samples_end <= cols.samples_start:
        wave_data = np.zeros((n, 0), dtype=np.int16)
    else:
        wave_data = raw_arr[:, cols.samples_start : samples_end]
    n_samples = min(wave_data.shape[1], wave_length)

    waves = np.zeros((n, wave_length), dtype=np.int16)
    if n_samples > 0:
        src = wave_data[:, :n_samples]
        waves[:, :n_samples] = src.astype(np.int16, copy=False) \
            if src.dtype == np.int16 else src.astype(np.int16)

    upstream = np.full(n, np.nan)
    if upstream_baseline is not None and len(upstream_baseline) == n:
        upstream = np.asarray(upstream_baseline, dtype=np.float64)

    return {
        "baseline": baselines,
        "baseline_upstream": upstream,
        "polarity": np.zeros(n, dtype=np.int8),
        "timestamp": timestamps,
        "record_id": np.zeros(n, dtype=np.int64),  # assigned after concat
        "dt": np.full(n, dt_ns, dtype=np.int32),
        "event_length": np.full(n, n_samples, dtype=np.int32),
        "board": boards,
        "channel": channels.astype(np.int16),
        "wave": waves,
    }


def apply_polarity_metadata(table: Table, context: Any, run_id: str) -> Table:
    """Per-channel polarity truth from channel metadata, vectorized."""
    n = len(table)
    if n == 0 or "polarity" not in table:
        return table
    pol = np.asarray(table["polarity"], dtype=np.int8).copy()
    groups = group_indices_by_hardware_channel(
        np.asarray(table["board"]), np.asarray(table["channel"])
    )
    for hw, idx in groups.items():
        p = get_polarity(context, run_id, hw.board, hw.channel)
        pol[idx] = POLARITY_CODES.get(p, 0)
    return table.with_columns(polarity=pol)


class WaveformsPlugin(Plugin):
    """Parse raw DAQ files into structured waveforms (st_waveforms)."""

    provides = "st_waveforms"
    # outputs depend on run_config channel_metadata (hardware overrides)
    uses_run_config = True
    description = (
        "Parse raw DAQ files and structure them into flat waveform records "
        "with baseline, timestamps (ps), and channel identity."
    )
    version = "3.1.0"
    save_when = "always"
    output_dtype = ST_WAVEFORM_SCHEMA
    options = {
        "daq_adapter": Option(default="vx2730", type=str, help="DAQ adapter name"),
        "wave_length": Option(
            default=None, type=int,
            help="Target wave length in samples (None -> detect from data)",
        ),
        "dt": Option(default=None, type=int, help="Sample interval (ns)"),
        "n_jobs": Option(
            default=None, type=int, track=False,
            help="File-level parallel parse jobs (perf knob, untracked)",
        ),
        "parse_engine": Option(
            default="auto", type=str, track=False,
            help="CSV engine: auto|pyarrow|pandas|numpy",
        ),
        "use_upstream_baseline": Option(
            default=False, type=bool,
            help="Fill baseline_upstream from an upstream 'baseline' data item",
        ),
        "baseline_samples": Option(
            default=None,
            help="Baseline window: int (first N samples) or (start, end)",
        ),
        "channel_mapping": Option(
            default=None, type=dict,
            help="{(board, channel): physical_channel} remapping",
        ),
        "device_unpack": Option(
            default=False, type=bool, track=False,
            help="V1725: unpack samples ON DEVICE (host does a header-only "
                 "walk; raw bytes upload once and a jitted gather/bit-slice "
                 "builds the wave matrix in HBM). Bit-identical to the host "
                 "walker; execution strategy only.",
        ),
        "streaming_mode": Option(
            default=False, type=bool, track=False,
            help="Memory-bounded ingest (reference cpu/waveforms.py:1457): "
                 "parse and structure file-by-file into disk-backed column "
                 "buffers instead of materializing every channel in RAM. "
                 "Bit-identical output; peak RSS ~ one file (or chunksize "
                 "rows) instead of the whole run.",
        ),
        "chunksize": Option(
            default=None, type=int, track=False,
            help="Row-count bound per structuring slice in streaming mode "
                 "(None = one file at a time); inert when streaming_mode is "
                 "off, matching the reference's chunked-CSV perf knob",
        ),
        "use_process_pool": Option(
            default=False, type=bool, track=False,
            help="Reference process-pool toggle for file parsing (inert "
                 "here; file parsing uses a thread pool over the native "
                 "decoder). Ledgered in docs/PARITY.md 'Inert reference "
                 "options'.",
        ),
    }

    def resolve_depends_on(self, context: Any, run_id: Optional[str] = None):
        deps = ["raw_files"]
        if context.get_config(self, "use_upstream_baseline"):
            deps.append("baseline")
        return deps

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        from waveformanalysis_tpu_torch.formats.adapter import get_adapter

        raw_files = context.get_data(run_id, "raw_files")
        adapter_name = (context.get_config(self, "daq_adapter") or "vx2730").lower()
        adapter = get_adapter(adapter_name)
        spec = adapter.format_spec

        wave_length = context.get_config(self, "wave_length")
        dt_ns = context.get_config(self, "dt")
        if dt_ns is None:
            rate = spec.sampling_rate_hz or 500e6
            dt_ns = max(1, int(round(1e9 / rate)))
        baseline_samples = context.get_config(self, "baseline_samples")
        channel_mapping = context.get_config(self, "channel_mapping")
        if channel_mapping:
            channel_mapping = {
                tuple(k) if isinstance(k, (list, tuple)) else k: v
                for k, v in channel_mapping.items()
            }
        n_jobs = context.get_config(self, "n_jobs")
        parse_engine = context.get_config(self, "parse_engine")

        upstream = None
        if context.get_config(self, "use_upstream_baseline"):
            try:
                upstream = context.get_data(run_id, "baseline")
            except Exception as e:
                logger.warning("Could not load upstream baseline: %s", e)

        if not raw_files:
            return Table.zeros(0, ST_WAVEFORM_SCHEMA,
                               wave_length=wave_length or 1)

        if adapter_name == "v1725":
            if context.get_config(self, "streaming_mode"):
                logger.info(
                    "streaming_mode: V1725 uses the header-scan builder "
                    "(already near-minimal residency); materialized path"
                )
            if context.get_config(self, "device_unpack"):
                table = self._compute_v1725_device(
                    adapter, raw_files, dt_ns, wave_length, context.device
                )
            else:
                table = self._compute_v1725(adapter, raw_files, dt_ns, wave_length)
            return apply_polarity_metadata(table, context, run_id)

        if context.get_config(self, "streaming_mode"):
            table = self._compute_streaming(
                adapter, raw_files,
                dt_ns=dt_ns, wave_length=wave_length,
                baseline_samples=baseline_samples,
                channel_mapping=channel_mapping,
                upstream=upstream,
                chunksize=context.get_config(self, "chunksize"),
                parse_engine=parse_engine,
            )
            return apply_polarity_metadata(table, context, run_id)

        # file-level parallel parse, grouped back per channel
        prof = context.profiler
        with prof.time("st_waveforms.decode"):
            per_channel = self._load_channels_flat(
                adapter, raw_files, n_jobs=n_jobs, parse_engine=parse_engine
            )
        with prof.time("st_waveforms.structure"):
            return self._structure_flat(context, run_id, spec, per_channel, wave_length,
                                        dt_ns, baseline_samples, channel_mapping, upstream)

    def _structure_flat(self, context, run_id, spec, per_channel, wave_length, dt_ns,
                        baseline_samples, channel_mapping, upstream) -> Table:
        """Structure the flat path's per-channel arrays into one Table."""
        if wave_length is None:
            detected = 0
            for arr in per_channel:
                if arr is not None and arr.size and arr.ndim == 2:
                    cols = spec.columns
                    end = cols.samples_end if cols.samples_end is not None else arr.shape[1]
                    detected = max(detected, end - cols.samples_start)
            wave_length = max(int(detected), 1)

        parts: List[Dict[str, np.ndarray]] = []
        for ch_idx, arr in enumerate(per_channel):
            if arr is None or arr.size == 0:
                continue
            up = None
            if upstream is not None and ch_idx < len(upstream):
                up = upstream[ch_idx]
            parts.append(
                structure_channel_array(
                    arr, spec, dt_ns=dt_ns, wave_length=wave_length,
                    baseline_samples=baseline_samples, channel_idx=ch_idx,
                    channel_mapping=channel_mapping, upstream_baseline=up,
                )
            )

        if not parts:
            return Table.zeros(0, ST_WAVEFORM_SCHEMA, wave_length=wave_length)

        cols_out = {
            k: np.concatenate([p[k] for p in parts]) for k in parts[0]
        }
        cols_out["record_id"] = np.arange(len(cols_out["timestamp"]), dtype=np.int64)
        table = Table(cols_out, schema=ST_WAVEFORM_SCHEMA)
        return apply_polarity_metadata(table, context, run_id)

    # -- helpers --------------------------------------------------------------

    def _load_channels_flat(
        self,
        adapter: Any,
        raw_files: List[List[str]],
        n_jobs: Optional[int],
        parse_engine: Optional[str],
    ) -> List[Optional[np.ndarray]]:
        """Parse every file in one flat thread pool, then stack per channel."""
        tasks = []  # (channel_idx, file_idx, path)
        for ch_idx, files in enumerate(raw_files):
            for f_idx, f in enumerate(files or []):
                tasks.append((ch_idx, f_idx, f))
        if not tasks:
            return [None] * len(raw_files)
        if n_jobs is None:
            n_jobs = min(len(tasks), 16)
        n_jobs = max(1, int(n_jobs))

        def parse(task):
            ch_idx, f_idx, path = task
            kwargs = {}
            if parse_engine and parse_engine != "auto":
                kwargs["parse_engine"] = parse_engine
            try:
                return ch_idx, f_idx, adapter.format_reader.read_file(
                    path, is_first_file=(f_idx == 0), **kwargs
                )
            except TypeError:
                return ch_idx, f_idx, adapter.format_reader.read_file(
                    path, is_first_file=(f_idx == 0)
                )

        results: Dict[int, Dict[int, np.ndarray]] = {}
        if n_jobs > 1:
            with ThreadPoolExecutor(max_workers=n_jobs) as pool:
                for ch_idx, f_idx, arr in pool.map(parse, tasks):
                    results.setdefault(ch_idx, {})[f_idx] = arr
        else:
            for task in tasks:
                ch_idx, f_idx, arr = parse(task)
                results.setdefault(ch_idx, {})[f_idx] = arr

        out: List[Optional[np.ndarray]] = []
        for ch_idx in range(len(raw_files)):
            files = results.get(ch_idx)
            if not files:
                out.append(None)
                continue
            arrs = [files[i] for i in sorted(files) if files[i].size > 0]
            out.append(np.vstack(arrs) if arrs else None)
        return out

    def _compute_streaming(
        self,
        adapter: Any,
        raw_files: List[List[str]],
        dt_ns: int,
        wave_length: Optional[int],
        baseline_samples: Any,
        channel_mapping: Optional[Dict[Tuple[int, int], int]],
        upstream: Optional[Any],
        chunksize: Optional[int],
        parse_engine: Optional[str] = None,
    ) -> Table:
        """Memory-bounded ingest (reference cpu/waveforms.py:1457).

        Two passes, bit-identical to the materialized path:

        1. parse each file ONCE (serially, in the same channel/file order
           the materialized path concatenates) and spill the raw row array
           to a temp ``.npy``, tracking row counts and the detected wave
           length — peak RSS is one file's parse;
        2. allocate the wave matrix as a disk-backed ``np.memmap`` plus RAM
           scalar columns (tiny next to the waves), then structure each
           spilled part — in row slices of ``chunksize`` when set — through
           the SAME ``structure_channel_array`` into the output slots.

        Per-row numerics (baseline window mean, ps timestamps, channel LUT,
        truncate/pad) depend only on the row, so per-file/per-slice
        structuring equals per-channel structuring byte-for-byte; record_id
        assignment over the identical concatenation order matches too.
        """
        import os
        import tempfile

        spec = adapter.format_spec
        cols = spec.columns
        tmp_root = tempfile.mkdtemp(prefix="wfa_stw_stream_")

        def parse_one(path: str, is_first: bool) -> np.ndarray:
            kwargs = {}
            if parse_engine and parse_engine != "auto":
                kwargs["parse_engine"] = parse_engine
            try:
                return adapter.format_reader.read_file(
                    path, is_first_file=is_first, **kwargs
                )
            except TypeError:
                return adapter.format_reader.read_file(
                    path, is_first_file=is_first
                )

        # ---- pass 1: parse + spill, detect wave length ----
        parts: List[Tuple[int, str, int]] = []  # (ch_idx, path, n_rows)
        ch_totals: Dict[int, int] = {}
        detected = 0
        for ch_idx, files in enumerate(raw_files):
            for f_idx, f in enumerate(files or []):
                arr = parse_one(f, is_first=(f_idx == 0))
                if arr is None or arr.size == 0:
                    continue
                end = (cols.samples_end if cols.samples_end is not None
                       else arr.shape[1])
                detected = max(detected, end - cols.samples_start)
                p = os.path.join(tmp_root, f"part{len(parts)}.npy")
                np.save(p, arr)
                parts.append((ch_idx, p, len(arr)))
                ch_totals[ch_idx] = ch_totals.get(ch_idx, 0) + len(arr)
                del arr

        if wave_length is None:
            wave_length = max(int(detected), 1)
        n_total = sum(n for _, _, n in parts)
        if n_total == 0:
            return Table.zeros(0, ST_WAVEFORM_SCHEMA, wave_length=wave_length)

        # ---- pass 2: structure into preallocated outputs ----
        wave = np.memmap(
            os.path.join(tmp_root, "wave.dat"), dtype=np.int16, mode="w+",
            shape=(n_total, wave_length),
        )
        out_cols: Dict[str, np.ndarray] = {
            "baseline": np.empty(n_total, np.float64),
            "baseline_upstream": np.empty(n_total, np.float64),
            "polarity": np.zeros(n_total, np.int8),
            "timestamp": np.empty(n_total, np.int64),
            "record_id": np.arange(n_total, dtype=np.int64),
            "dt": np.empty(n_total, np.int32),
            "event_length": np.empty(n_total, np.int32),
            "board": np.empty(n_total, np.int16),
            "channel": np.empty(n_total, np.int16),
        }
        offset = 0
        ch_row_offset: Dict[int, int] = {}
        for ch_idx, p, n_rows in parts:
            arr = np.load(p, mmap_mode="r")
            ch_up = None
            if upstream is not None and ch_idx < len(upstream):
                cand = upstream[ch_idx]
                # the materialized path only applies an upstream baseline
                # whose length matches the channel's total row count
                if cand is not None and len(cand) == ch_totals[ch_idx]:
                    ch_up = cand
            step = int(chunksize) if chunksize and chunksize > 0 else n_rows
            for s in range(0, n_rows, step):
                sl = np.asarray(arr[s:s + step])
                m = len(sl)
                up = None
                if ch_up is not None:
                    base = ch_row_offset.get(ch_idx, 0) + s
                    up = np.asarray(ch_up[base:base + m])
                part_cols = structure_channel_array(
                    sl, spec, dt_ns=dt_ns, wave_length=wave_length,
                    baseline_samples=baseline_samples, channel_idx=ch_idx,
                    channel_mapping=channel_mapping, upstream_baseline=up,
                )
                for k, v in part_cols.items():
                    if k == "wave":
                        wave[offset:offset + m] = v
                    elif k != "record_id":
                        out_cols[k][offset:offset + m] = v
                offset += m
                del sl, part_cols
            ch_row_offset[ch_idx] = ch_row_offset.get(ch_idx, 0) + n_rows
            del arr
            os.remove(p)
        wave.flush()
        out_cols["wave"] = wave
        return Table(out_cols, schema=ST_WAVEFORM_SCHEMA)

    def _compute_v1725_device(
        self,
        adapter: Any,
        raw_files: List[List[str]],
        dt_ns: int,
        wave_length: Optional[int],
        device: Any,
    ) -> Table:
        """Device-unpacked V1725 path.

        The host walks headers only; a torch gather on ``device`` (the
        Context's) builds the padded wave matrix there
        (ops/v1725_device.py). Bit-identical to :meth:`_compute_v1725`
        (tests/test_torch_v1725_device.py). The wave column stays the
        device tensor: the fused kernels consume it without re-upload
        (_wave_source.wave_matrix_view), and the Context moves it to the
        host when the outermost get_data returns.
        """
        from waveformanalysis_tpu_torch.ops.v1725_device import read_files_device

        files, seen = [], set()
        for group in raw_files:
            for f in group or []:
                if f not in seen:
                    seen.add(f)
                    files.append(f)
        waves_d, meta = read_files_device(
            files, wave_length=wave_length,
            board_from_path=adapter.format_reader._extract_board_from_path,
            device=device,
        )
        n = len(meta["offset"])
        if n == 0:
            return Table.zeros(0, ST_WAVEFORM_SCHEMA,
                               wave_length=wave_length or 1)
        ts_ps = adapter.format_spec.normalize_timestamp_to_ps(
            meta["timestamp"], dt_ns=dt_ns
        )
        L = int(waves_d.shape[1])
        return Table(
            {
                "baseline": meta["baseline"],
                "baseline_upstream": np.full(n, np.nan),
                "polarity": np.zeros(n, dtype=np.int8),
                "timestamp": ts_ps.astype(np.int64),
                "record_id": np.arange(n, dtype=np.int64),
                "dt": np.full(n, dt_ns, dtype=np.int32),
                "event_length": np.minimum(meta["n_samples"], L).astype(
                    np.int32
                ),
                "board": meta["board"],
                "channel": meta["channel"],
                "wave": waves_d,
            },
            schema=ST_WAVEFORM_SCHEMA,
        )

    def _compute_v1725(
        self,
        adapter: Any,
        raw_files: List[List[str]],
        dt_ns: int,
        wave_length: Optional[int],
    ) -> Table:
        files, seen = [], set()
        for group in raw_files:
            for f in group or []:
                if f not in seen:
                    seen.add(f)
                    files.append(f)
        data = adapter.format_reader.read_files(files)
        if data.size == 0:
            return Table.zeros(0, ST_WAVEFORM_SCHEMA, wave_length=wave_length or 1)
        n = len(data)
        lengths = np.array([len(w) for w in data["wave"]], dtype=np.int32)
        L = int(wave_length) if wave_length else int(lengths.max())
        waves = np.zeros((n, L), dtype=np.int16)
        for i in range(n):
            w = data["wave"][i][:L]
            waves[i, : len(w)] = w
        ts_ps = adapter.format_spec.normalize_timestamp_to_ps(
            data["timestamp"].astype(np.int64), dt_ns=dt_ns
        )
        return Table(
            {
                "baseline": data["baseline"].astype(np.float64),
                "baseline_upstream": np.full(n, np.nan),
                "polarity": np.zeros(n, dtype=np.int8),
                "timestamp": ts_ps.astype(np.int64),
                "record_id": np.arange(n, dtype=np.int64),
                "dt": np.full(n, dt_ns, dtype=np.int32),
                "event_length": np.minimum(lengths, L).astype(np.int32),
                "board": data["board"].astype(np.int16),
                "channel": data["channel"].astype(np.int16),
                "wave": waves,
            },
            schema=ST_WAVEFORM_SCHEMA,
        )


class WaveformStructConfig:
    """Format-decoupled structuring config
    (reference: waveforms.py WaveformStructConfig; tested by the
    reference's test_waveform_struct_decoupling): carries the FormatSpec
    plus optional explicit wave_length / baseline window, with the
    documented resolution priority wave_length > DEFAULT_WAVE_LENGTH."""

    def __init__(self, format_spec: Any, wave_length: Optional[int] = None,
                 baseline_samples: Any = None) -> None:
        self.format_spec = format_spec
        self.wave_length = wave_length
        self.baseline_samples = baseline_samples

    @classmethod
    def default_vx2730(cls) -> "WaveformStructConfig":
        from waveformanalysis_tpu_torch.formats.vx2730 import VX2730_SPEC

        return cls(format_spec=VX2730_SPEC)

    @classmethod
    def from_adapter(cls, adapter_name: str) -> "WaveformStructConfig":
        from waveformanalysis_tpu_torch.formats.adapter import get_adapter

        return cls(format_spec=get_adapter(adapter_name).format_spec)

    def get_wave_length(self) -> int:
        from waveformanalysis_tpu_torch.dtypes.schema import DEFAULT_WAVE_LENGTH

        return (int(self.wave_length) if self.wave_length is not None
                else DEFAULT_WAVE_LENGTH)

    def get_record_dtype(self):
        from waveformanalysis_tpu_torch.dtypes.schema import create_record_dtype

        return create_record_dtype(self.get_wave_length())

    def make_struct(self, waveforms: List[np.ndarray],
                    dt_ns: int) -> "WaveformStruct":
        return WaveformStruct(waveforms, self.format_spec, dt_ns,
                              wave_length=self.wave_length,
                              baseline_samples=self.baseline_samples)


class WaveformStruct:
    """Thin API-parity shim over :func:`structure_channel_array`
    (reference: waveforms.py:591)."""

    def __init__(self, waveforms: List[np.ndarray], spec: Any, dt_ns: int,
                 wave_length: Optional[int] = None,
                 baseline_samples: Any = None) -> None:
        self.waveforms = waveforms
        self.spec = spec
        self.dt_ns = dt_ns
        self.wave_length = wave_length
        self.baseline_samples = baseline_samples

    def structure_waveforms(self) -> Table:
        cols = self.spec.columns
        wave_length = self.wave_length
        if wave_length is None:
            detected = 0
            for arr in self.waveforms:
                if arr is not None and arr.size and arr.ndim == 2:
                    end = cols.samples_end if cols.samples_end is not None else arr.shape[1]
                    detected = max(detected, end - cols.samples_start)
            wave_length = max(detected, 1)
        parts = [
            structure_channel_array(
                arr, self.spec, dt_ns=self.dt_ns, wave_length=wave_length,
                baseline_samples=self.baseline_samples, channel_idx=i,
            )
            for i, arr in enumerate(self.waveforms)
            if arr is not None and arr.size
        ]
        if not parts:
            return Table.zeros(0, ST_WAVEFORM_SCHEMA, wave_length=wave_length)
        cols_out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        cols_out["record_id"] = np.arange(len(cols_out["timestamp"]), dtype=np.int64)
        return Table(cols_out, schema=ST_WAVEFORM_SCHEMA)
