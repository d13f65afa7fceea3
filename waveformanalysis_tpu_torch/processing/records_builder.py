"""Records + wave_pool construction.

Port of ``waveformanalysis_tpu/processing/records_builder.py``. Behavioral
analog of the reference records builder
(reference: waveform_analysis/core/processing/records_builder.py:115-1000):
raw per-channel arrays (or st_waveforms) become one globally time-sorted
``records`` table plus a contiguous uint16 ``wave_pool`` addressed by
``wave_offset``/``event_length``. The sort contract is identical -- stable
order by (timestamp, pid, board, channel, input order) -- and record_ids are
sequential after the global sort.

The merge is vectorized: concatenate parts, one sort over the keys (a
single stable argsort of the timestamps when it provably realizes the
full order, else ``np.lexsort``), then an O(total_samples) gather rebuilds
the wave_pool. The sort can also run as torch ops on a device
(:func:`records_sort_order_device`, backend ``device``); ``auto`` resolves
to the host. ``merge_records_parts(mesh=...)`` sorts over a device mesh
with the distributed block odd-even merge (``parallel/sorted_merge.py``).
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

from waveformanalysis_tpu_torch.dtypes.schema import RECORDS_SCHEMA
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.hardware import group_indices_by_hardware_channel

logger = logging.getLogger(__name__)

DEFAULT_PART_SIZE = 250_000


def _phase(profiler: Any, name: str):
    """``profiler.time(name)``, or nothing without a profiler."""
    return profiler.time(name) if profiler is not None else nullcontext()


@dataclass
class RecordsBundle:
    """records table + contiguous wave_pool (uint16 samples)."""

    records: Table
    wave_pool: np.ndarray

    def __len__(self) -> int:
        return len(self.records)

    @property
    def nbytes(self) -> int:
        host = self.records.to_host()
        return int(
            sum(np.asarray(v).nbytes for v in host.columns.values())
            + self.wave_pool.nbytes
        )


def empty_bundle() -> RecordsBundle:
    return RecordsBundle(
        records=Table.zeros(0, RECORDS_SCHEMA),
        wave_pool=np.zeros(0, dtype=np.uint16),
    )


# --------------------------------------------------------------------------
# Sorting / merging primitives
# --------------------------------------------------------------------------

def records_sort_order(records: Table) -> np.ndarray:
    """Stable global sort: primary timestamp, then pid, board, channel,
    then input order (reference: records_builder.py:115-120).

    Fast path: the builder concatenates per-channel parts that are each
    time-sorted, in channel order — so a SINGLE stable argsort of the
    timestamps (timsort: merges the k sorted runs in ~O(n log k)) usually
    already realizes the full (timestamp, pid, board, channel, seq) order,
    because equal-timestamp ties keep concatenation order = channel order.
    That candidate order is VERIFIED against the full key in one vectorized
    O(n) pass; any violation (e.g. multi-board ties, interleaved pids)
    falls back to the exact 5-key lexsort. Output is identical to the
    lexsort on every input — the fast path is only taken when proven
    equivalent."""
    n = len(records)
    ts = np.asarray(records["timestamp"])
    order = np.argsort(ts, kind="stable")
    if n > 1:
        ts_s = ts[order]
        tie = ts_s[1:] == ts_s[:-1]
        if tie.any():
            pid = np.asarray(records["pid"])[order]
            board = np.asarray(records["board"])[order]
            channel = np.asarray(records["channel"])[order]
            # non-decreasing (pid, board, channel, seq) within each tie run?
            p0, p1 = pid[:-1], pid[1:]
            b0, b1 = board[:-1], board[1:]
            c0, c1 = channel[:-1], channel[1:]
            s_inc = order[1:] > order[:-1]  # stable: seq always increases
            ok = (
                (p1 > p0)
                | ((p1 == p0) & (b1 > b0))
                | ((p1 == p0) & (b1 == b0) & (c1 > c0))
                | ((p1 == p0) & (b1 == b0) & (c1 == c0) & s_inc)
            )
            if not bool(np.all(ok | ~tie)):
                seq = np.arange(n, dtype=np.int64)
                return np.lexsort(
                    (
                        seq,
                        np.asarray(records["channel"]),
                        np.asarray(records["board"]),
                        np.asarray(records["pid"]),
                        ts,
                    )
                )
    return order


def records_sort_order_device(records: Table, device: Any = "cuda") -> np.ndarray:
    """``records_sort_order`` computed as torch ops on ``device``.

    Key order matches the host order exactly: timestamp, pid, board,
    channel, then input order. Four stable sorts run from the least
    significant key to the most significant one, each permuting the order
    so far; stability carries the input order, as in ``np.lexsort``.
    ``device`` is explicit: ``"cuda"`` without a GPU raises. Returns the
    int64 permutation on the host.
    """
    import torch

    from waveformanalysis_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    n = len(records)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = torch.arange(n, dtype=torch.int64, device=dev)
    for name, dtype in (("channel", np.int32), ("board", np.int32), ("pid", np.int32),
                        ("timestamp", np.int64)):
        key = torch.from_numpy(np.ascontiguousarray(records[name], dtype=dtype)).to(dev)
        order = order[torch.argsort(key[order], stable=True)]
    return order.cpu().numpy()


def resolve_records_sort_backend(backend: str = "auto") -> str:
    """auto|host|device -> host|device for the records global sort.

    ``auto`` resolves to host, as in the JAX package; the device order's
    times on the card are the numbers that decide it (PERF.md). Env
    WFA_RECORDS_SORT_BACKEND overrides for A/B runs.
    """
    import os

    env = os.environ.get("WFA_RECORDS_SORT_BACKEND")
    if env in ("host", "device"):
        return env
    if backend in ("host", "device"):
        return backend
    if backend != "auto":
        raise ValueError(f"unknown records sort backend {backend!r}")
    return "host"


def gather_pool(
    pool: np.ndarray, offsets: np.ndarray, lengths: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized variable-length slice gather.

    Returns (new_pool, new_offsets): new_pool concatenates
    ``pool[offsets[i] : offsets[i]+lengths[i]]`` in order.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    total = int(lengths.sum())
    new_offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]) if len(lengths) else np.zeros(0, np.int64)
    if total == 0:
        return np.zeros(0, dtype=pool.dtype), new_offsets.astype(np.int64)
    if np.array_equal(offsets, new_offsets):
        # already contiguous in this order
        return pool[: total].copy(), new_offsets.astype(np.int64)
    if (
        lengths[0] > 0
        and np.all(lengths == lengths[0])
        and pool.size % int(lengths[0]) == 0
        and np.all(offsets % int(lengths[0]) == 0)
    ):
        # fixed-length fast path: a row gather instead of per-sample indices
        L = int(lengths[0])
        return pool.reshape(-1, L)[offsets // L].ravel(), new_offsets.astype(np.int64)
    # general variable-length path: out_idx -> source sample index
    src_index = np.repeat(offsets - new_offsets, lengths) + np.arange(
        total, dtype=np.int64
    )
    return pool[src_index], new_offsets.astype(np.int64)


def sort_bundle(bundle: RecordsBundle, sort_backend: str = "auto",
                device: Any = "cuda", profiler: Any = None) -> RecordsBundle:
    """Globally sort a bundle and rebuild its wave_pool contiguously
    (``device`` is where the ``device`` sort backend runs; ``profiler``
    times the ``records.sort`` and ``records.gather`` phases)."""
    n = len(bundle.records)
    if n == 0:
        return bundle
    with _phase(profiler, "records.sort"):
        if resolve_records_sort_backend(sort_backend) == "device":
            order = records_sort_order_device(bundle.records, device=device)
        else:
            order = records_sort_order(bundle.records)
    with _phase(profiler, "records.gather"):
        records = bundle.records[order]
        new_pool, new_offsets = gather_pool(
            bundle.wave_pool,
            np.asarray(records["wave_offset"]),
            np.asarray(records["event_length"]),
        )
    records = records.with_columns(
        wave_offset=new_offsets,
        record_id=np.arange(n, dtype=np.int64),
    )
    return RecordsBundle(records=records, wave_pool=new_pool)


def merge_records_parts(
    parts: Sequence[RecordsBundle], mesh: Any = None, profiler: Any = None
) -> RecordsBundle:
    """Merge per-channel/per-part bundles into one sorted bundle.

    Vectorized replacement for the reference k-way heap merge
    (records_builder.py:870-948): concatenation + one sort + one gather.

    With ``mesh`` (a ``parallel.make_mesh`` Mesh of more than one device),
    the global sort runs as the distributed block odd-even merge
    (parallel/sorted_merge.py) sharded over the mesh. The wave_pool gather
    stays on the host (ragged), matching the host path bit for bit.
    """
    parts = [p for p in parts if len(p.records) > 0]
    if not parts:
        return empty_bundle()
    if mesh is not None and mesh.size > 1:
        return _merge_records_parts_on_mesh(parts, mesh, profiler)
    if len(parts) == 1:
        return sort_bundle(parts[0], profiler=profiler)

    with _phase(profiler, "records.concat"):
        records, pool = _concat_rebased(parts)
    return sort_bundle(RecordsBundle(records=records, wave_pool=pool), profiler=profiler)


def _merge_records_parts_on_mesh(
    parts: Sequence[RecordsBundle], mesh: Any, profiler: Any = None
) -> RecordsBundle:
    """Distributed merge: global record order via the sharded block
    odd-even merge, wave_pool gathered on the host.

    Order contract identical to :func:`records_sort_order` -- primary
    timestamp, then pid/board/channel, then input order (carried as an
    explicit sequence key so the distributed sort is deterministic)."""
    from waveformanalysis_tpu_torch.parallel.sorted_merge import sharded_time_sort

    with _phase(profiler, "records.concat"):
        records, pool = _concat_rebased(parts)
    n = len(records)
    cols = {k: np.asarray(records[k]) for k in records.field_names}
    cols["_seq"] = np.arange(n, dtype=np.int64)
    with _phase(profiler, "records.sort"):
        sorted_cols = sharded_time_sort(
            cols, ("timestamp", "pid", "board", "channel", "_seq"), mesh,
        )
    with _phase(profiler, "records.gather"):
        out = Table(
            {k: sorted_cols[k] for k in records.field_names},
            schema=records.schema, validate=False,
        )
        new_pool, new_offsets = gather_pool(
            pool,
            np.asarray(sorted_cols["wave_offset"], dtype=np.int64),
            np.asarray(sorted_cols["event_length"], dtype=np.int64),
        )
    out = out.with_columns(
        wave_offset=new_offsets,
        record_id=np.arange(n, dtype=np.int64),
    )
    return RecordsBundle(records=out, wave_pool=new_pool)


def _concat_rebased(parts: Sequence[RecordsBundle]):
    """Concatenate part tables with wave_pool offsets rebased."""
    pool_sizes = [len(p.wave_pool) for p in parts]
    pool_bases = np.concatenate([[0], np.cumsum(pool_sizes)[:-1]]).astype(np.int64)
    rebased = []
    for base, p in zip(pool_bases, parts):
        rec = p.records
        rebased.append(
            rec.with_columns(
                wave_offset=np.asarray(rec["wave_offset"], dtype=np.int64) + base
            )
        )
    records = Table.concatenate(rebased)
    pool = np.concatenate([p.wave_pool for p in parts]) if pool_sizes else np.zeros(0, np.uint16)
    return records, pool


# --------------------------------------------------------------------------
# Part construction
# --------------------------------------------------------------------------

def resolve_baseline_window(
    baseline_samples: Union[int, Tuple[int, int], list, None],
    samples_start: int,
    baseline_start: int,
    baseline_end: int,
) -> Tuple[int, int]:
    """Reference semantics (records_builder.py:94-106): None -> the format's
    baseline columns; int n -> first n sample columns; (a, b) -> sample-
    relative window."""
    if baseline_samples is None:
        return baseline_start, baseline_end
    if isinstance(baseline_samples, (tuple, list)) and len(baseline_samples) == 2:
        return (
            samples_start + int(baseline_samples[0]),
            samples_start + int(baseline_samples[1]),
        )
    return samples_start, samples_start + int(baseline_samples)


def build_part_from_typed(
    dec: dict,
    default_dt_ns: int,
    normalize_timestamp_to_ps,
    pid: int = 0,
    sort: bool = True,
) -> RecordsBundle:
    """One sorted part from the typed native decode output.

    ``dec`` is the dict from native.decode_csv_vx2730_typed (board/channel
    i16, timestamp i64, baseline f8, samples u16). Produces exactly what
    :func:`build_part_from_raw_array` would from the same file — the typed
    decoder already emitted the final dtypes and folded the baseline-window
    mean into the parse pass, so this is just column assembly.
    """
    n = len(dec["timestamp"])
    if n == 0:
        return empty_bundle()
    timestamps = normalize_timestamp_to_ps(
        np.asarray(dec["timestamp"], dtype=np.int64), dt_ns=int(default_dt_ns)
    ).astype(np.int64)
    samples = np.asarray(dec["samples"])
    wave_length = int(samples.shape[1])
    records = Table(
        {
            "timestamp": timestamps,
            "pid": np.full(n, pid, dtype=np.int32),
            "board": np.asarray(dec["board"], dtype=np.int16),
            "channel": np.asarray(dec["channel"], dtype=np.int16),
            "baseline": np.asarray(dec["baseline"], dtype=np.float64),
            "baseline_upstream": np.full(n, np.nan),
            "polarity": np.zeros(n, dtype=np.int8),  # unknown
            "record_id": np.arange(n, dtype=np.int64),
            "dt": np.full(n, default_dt_ns, dtype=np.int32),
            "trigger_type": np.zeros(n, dtype=np.int16),
            "flags": np.zeros(n, dtype=np.uint32),
            "wave_offset": np.arange(n, dtype=np.int64) * wave_length,
            "event_length": np.full(n, wave_length, dtype=np.int32),
            "time": timestamps // 1000,
        },
        schema=RECORDS_SCHEMA,
    )
    pool = np.ascontiguousarray(samples, dtype=np.uint16).reshape(-1)
    bundle = RecordsBundle(records=records, wave_pool=pool)
    # parts feeding merge_records_parts skip the per-part sort: the merge
    # lexsorts the concatenation anyway (pre-sorted parts are wasted work)
    return sort_bundle(bundle) if sort else bundle


def raw_array_to_typed(
    raw_arr: np.ndarray, cols: Any, b_start: int, b_end: int,
    channel_idx: int = 0,
) -> dict:
    """Convert a generic f64 decode matrix to the typed-decode layout.

    Used when one file in a channel falls back to the generic decoder so it
    can join the typed part buffers. Conversions mirror
    build_part_from_raw_array exactly (incl. the board/channel zero
    fallback on non-finite values).
    """
    n = len(raw_arr)
    try:
        boards = raw_arr[:, cols.board].astype(np.int16)
    except (ValueError, TypeError):
        boards = np.zeros(n, dtype=np.int16)
    try:
        channels = raw_arr[:, cols.channel].astype(np.int16)
    except (ValueError, TypeError):
        channels = np.full(n, int(channel_idx), dtype=np.int16)
    b_end_c = min(b_end, raw_arr.shape[1])
    if b_end_c <= b_start:
        baselines = np.full(n, np.nan, dtype=np.float64)
    else:
        baselines = np.mean(raw_arr[:, b_start:b_end_c].astype(np.float64), axis=1)
    samples_end = cols.samples_end if cols.samples_end is not None else raw_arr.shape[1]
    samples_end = min(samples_end, raw_arr.shape[1])
    if samples_end <= cols.samples_start:
        samples = np.zeros((n, 0), dtype=np.uint16)
    else:
        samples = raw_arr[:, cols.samples_start:samples_end].astype(np.uint16)
    return {
        "board": boards,
        "channel": channels,
        "timestamp": raw_arr[:, cols.timestamp].astype(np.int64),
        "baseline": baselines,
        "samples": samples,
    }


def concat_typed(parts: List[dict]) -> dict:
    if len(parts) == 1:
        return parts[0]
    return {
        k: (np.vstack([p[k] for p in parts]) if parts[0][k].ndim == 2
            else np.concatenate([p[k] for p in parts]))
        for k in parts[0]
    }


def build_part_from_raw_array(
    raw_arr: np.ndarray,
    channel_idx: int,
    default_dt_ns: int,
    cols: Any,
    normalize_timestamp_to_ps,
    baseline_samples: Union[int, Tuple[int, int], None] = None,
    pid: int = 0,
) -> RecordsBundle:
    """One sorted part from a 2-D raw CSV array (fixed wave length)."""
    if raw_arr.size == 0:
        return empty_bundle()
    if raw_arr.ndim != 2:
        raise ValueError("raw waveform array must be 2D")
    n = len(raw_arr)

    timestamps = normalize_timestamp_to_ps(
        raw_arr[:, cols.timestamp].astype(np.int64), dt_ns=int(default_dt_ns)
    ).astype(np.int64)
    try:
        boards = raw_arr[:, cols.board].astype(np.int16)
    except (ValueError, TypeError):
        boards = np.zeros(n, dtype=np.int16)
    try:
        channels = raw_arr[:, cols.channel].astype(np.int16)
    except (ValueError, TypeError):
        channels = np.full(n, int(channel_idx), dtype=np.int16)

    b_start, b_end = resolve_baseline_window(
        baseline_samples, cols.samples_start, cols.baseline_start, cols.baseline_end
    )
    b_end = min(b_end, raw_arr.shape[1])
    if b_end <= b_start:
        baselines = np.full(n, np.nan, dtype=np.float64)
    else:
        baselines = np.mean(raw_arr[:, b_start:b_end].astype(np.float64), axis=1)

    samples_end = cols.samples_end if cols.samples_end is not None else raw_arr.shape[1]
    samples_end = min(samples_end, raw_arr.shape[1])
    if samples_end <= cols.samples_start:
        wave_data = np.zeros((n, 0), dtype=np.uint16)
    else:
        wave_data = raw_arr[:, cols.samples_start : samples_end]
    wave_length = int(wave_data.shape[1])

    records = Table(
        {
            "timestamp": timestamps,
            "pid": np.full(n, pid, dtype=np.int32),
            "board": boards,
            "channel": channels,
            "baseline": baselines,
            "baseline_upstream": np.full(n, np.nan),
            "polarity": np.zeros(n, dtype=np.int8),  # unknown
            "record_id": np.arange(n, dtype=np.int64),
            "dt": np.full(n, default_dt_ns, dtype=np.int32),
            "trigger_type": np.zeros(n, dtype=np.int16),
            "flags": np.zeros(n, dtype=np.uint32),
            "wave_offset": np.arange(n, dtype=np.int64) * wave_length,
            "event_length": np.full(n, wave_length, dtype=np.int32),
            "time": timestamps // 1000,
        },
        schema=RECORDS_SCHEMA,
    )
    pool = np.ascontiguousarray(wave_data).astype(np.uint16, copy=False).reshape(-1)
    return sort_bundle(RecordsBundle(records=records, wave_pool=pool))


def split_by_hardware_channel(st_waveforms: Any) -> List[Tuple[Any, Any]]:
    """Split rows into per-hardware-channel groups, (board, channel)
    ascending; same channel number on different boards stays separate.

    Accepts a structured array or a Table; groups are views/row-subsets of
    the same kind. Reference surface:
    waveform_analysis/core/processing/records_builder.py:124
    (split_by_hardware_channel).
    """
    if st_waveforms is None or len(st_waveforms) == 0:
        return []
    is_table = isinstance(st_waveforms, Table)
    fields = (st_waveforms.field_names if is_table
              else (st_waveforms.dtype.names
                    if isinstance(st_waveforms, np.ndarray) else None))
    if fields is None:
        raise ValueError(
            "st_waveforms must be a structured numpy array or Table")
    if "board" not in fields or "channel" not in fields:
        raise ValueError(
            "st_waveforms missing required 'board'/'channel' fields")
    groups = group_indices_by_hardware_channel(
        np.asarray(st_waveforms["board"]),
        np.asarray(st_waveforms["channel"]))
    return [(hw, st_waveforms[idx]) for hw, idx in groups.items()]


def split_by_channel(st_waveforms: Any) -> List[Tuple[int, Any]]:
    """Backward-compatible per-channel split for SINGLE-board inputs only
    (reference: records_builder.py:153 — multi-board data must use
    split_by_hardware_channel)."""
    groups = split_by_hardware_channel(st_waveforms)
    if any(hw.board != 0 for hw, _ in groups):
        raise ValueError(
            "split_by_channel no longer supports multi-board data; use "
            "split_by_hardware_channel instead.")
    return [(hw.channel, group) for hw, group in groups]


def build_records_from_st_waveforms(
    st_waveforms: Any,
    default_dt_ns: int = 1,
    part_size: Optional[int] = None,
) -> RecordsBundle:
    """Build a bundle from st_waveforms (Table or structured array).

    part_size is accepted for API parity but the vectorized path needs no
    sharding — a single lexsort handles any size.
    """
    if not isinstance(st_waveforms, Table):
        st_waveforms = Table.from_numpy(st_waveforms)
    n = len(st_waveforms)
    if n == 0:
        return empty_bundle()

    waves = np.asarray(st_waveforms["wave"])
    event_length = (
        np.asarray(st_waveforms["event_length"], dtype=np.int32)
        if "event_length" in st_waveforms
        else np.full(n, waves.shape[1], dtype=np.int32)
    )
    timestamps = np.asarray(st_waveforms["timestamp"], dtype=np.int64)
    dt = (
        np.asarray(st_waveforms["dt"], dtype=np.int32)
        if "dt" in st_waveforms
        else np.full(n, default_dt_ns, dtype=np.int32)
    )
    records = Table(
        {
            "timestamp": timestamps,
            "pid": np.zeros(n, dtype=np.int32),
            "board": np.asarray(st_waveforms.get("board", np.zeros(n, np.int16)), dtype=np.int16),
            "channel": np.asarray(st_waveforms.get("channel", np.zeros(n, np.int16)), dtype=np.int16),
            "baseline": np.asarray(st_waveforms.get("baseline", np.zeros(n)), dtype=np.float64),
            "baseline_upstream": np.asarray(
                st_waveforms.get("baseline_upstream", np.full(n, np.nan)), dtype=np.float64
            ),
            "polarity": np.asarray(st_waveforms.get("polarity", np.zeros(n, np.int8)), dtype=np.int8),
            "record_id": np.arange(n, dtype=np.int64),
            "dt": dt,
            "trigger_type": np.zeros(n, dtype=np.int16),
            "flags": np.zeros(n, dtype=np.uint32),
            "wave_offset": np.arange(n, dtype=np.int64) * waves.shape[1],
            "event_length": event_length,
            "time": timestamps // 1000,
        },
        schema=RECORDS_SCHEMA,
    )
    pool = waves.astype(np.uint16, copy=False).reshape(-1)
    bundle = sort_bundle(RecordsBundle(records=records, wave_pool=pool))
    # drop padded tails: clip pool slices to event_length
    if np.any(event_length != waves.shape[1]):
        rec = bundle.records
        new_pool, new_offsets = gather_pool(
            bundle.wave_pool,
            np.asarray(rec["wave_offset"]),
            np.asarray(rec["event_length"]),
        )
        bundle = RecordsBundle(
            records=rec.with_columns(wave_offset=new_offsets), wave_pool=new_pool
        )
    return bundle


# Alias for reference API parity
build_records_from_st_waveforms_sharded = build_records_from_st_waveforms


def build_records_from_v1725_files(
    file_list: Sequence[Any],
    default_dt_ns: int = 4,
    reader: Any = None,
    profiler: Any = None,
) -> RecordsBundle:
    """Build a bundle straight from V1725 binary files (variable lengths).

    Fast path: the native C++ decoder parses each file's bytes directly
    into columnar arrays + pool; the Python reader remains as the
    toolchain-free fallback.
    """
    from pathlib import Path

    from waveformanalysis_tpu_torch.formats.v1725 import V1725Reader
    from waveformanalysis_tpu_torch.native import decode_v1725_bytes, get_lib

    reader = reader or V1725Reader()

    if get_lib() is not None and file_list:
        cols = {k: [] for k in ("board", "channel", "timestamp", "baseline",
                                "trunc", "event_length")}
        pools: List[np.ndarray] = []
        pool_base = 0
        offsets_parts: List[np.ndarray] = []
        decoded_any = True
        for f in file_list:
            p = Path(f)
            if not p.exists():
                logger.warning("File not found: %s", p)
                continue
            with _phase(profiler, "records.decode"):
                raw = p.read_bytes()
                if profiler is not None:
                    profiler.count("records.decode_bytes", len(raw))
                dec = decode_v1725_bytes(raw)
            if dec is None:
                decoded_any = False
                break
            board = reader._extract_board_from_path(p)
            nrec = len(dec["channel"])
            cols["board"].append(np.full(nrec, board, dtype=np.int16))
            cols["channel"].append(dec["channel"])
            cols["timestamp"].append(dec["timestamp"])
            cols["baseline"].append(dec["baseline"])
            cols["trunc"].append(dec["trunc"])
            cols["event_length"].append(dec["event_length"])
            offsets_parts.append(dec["wave_offset"] + pool_base)
            pools.append(dec["wave_pool"])
            pool_base += len(dec["wave_pool"])
        if decoded_any:
            if not pools:
                return empty_bundle()
            cat = {k: np.concatenate(v) for k, v in cols.items()}
            n = len(cat["channel"])
            if n == 0:
                return empty_bundle()
            ts_ps = reader.spec.normalize_timestamp_to_ps(
                cat["timestamp"], dt_ns=default_dt_ns
            ).astype(np.int64)
            records = Table(
                {
                    "timestamp": ts_ps,
                    "pid": np.zeros(n, dtype=np.int32),
                    "board": cat["board"],
                    "channel": cat["channel"].astype(np.int16),
                    "baseline": cat["baseline"],
                    "baseline_upstream": np.full(n, np.nan),
                    "polarity": np.zeros(n, dtype=np.int8),
                    "record_id": np.arange(n, dtype=np.int64),
                    "dt": np.full(n, default_dt_ns, dtype=np.int32),
                    "trigger_type": np.zeros(n, dtype=np.int16),
                    "flags": np.where(cat["trunc"] > 0, np.uint32(1),
                                      np.uint32(0)),
                    "wave_offset": np.concatenate(offsets_parts),
                    "event_length": cat["event_length"],
                    "time": ts_ps // 1000,
                },
                schema=RECORDS_SCHEMA,
            )
            return sort_bundle(
                RecordsBundle(records=records,
                              wave_pool=np.concatenate(pools)),
                profiler=profiler,
            )

    data = reader.read_files(list(file_list))
    if data.size == 0:
        return empty_bundle()
    n = len(data)
    lengths = np.array([len(w) for w in data["wave"]], dtype=np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    pool = np.zeros(int(lengths.sum()), dtype=np.uint16)
    for i in range(n):
        pool[offsets[i] : offsets[i] + lengths[i]] = data["wave"][i].astype(np.uint16)
    ts_ps = reader.spec.normalize_timestamp_to_ps(
        data["timestamp"].astype(np.int64), dt_ns=default_dt_ns
    )
    flags = np.where(data["trunc"], np.uint32(1), np.uint32(0))
    records = Table(
        {
            "timestamp": ts_ps.astype(np.int64),
            "pid": np.zeros(n, dtype=np.int32),
            "board": data["board"].astype(np.int16),
            "channel": data["channel"].astype(np.int16),
            "baseline": data["baseline"].astype(np.float64),
            "baseline_upstream": np.full(n, np.nan),
            "polarity": np.zeros(n, dtype=np.int8),
            "record_id": np.arange(n, dtype=np.int64),
            "dt": np.full(n, default_dt_ns, dtype=np.int32),
            "trigger_type": np.zeros(n, dtype=np.int16),
            "flags": flags,
            "wave_offset": offsets,
            "event_length": lengths,
            "time": ts_ps // 1000,
        },
        schema=RECORDS_SCHEMA,
    )
    return sort_bundle(RecordsBundle(records=records, wave_pool=pool))


def build_records_from_raw_files(
    raw_files: List[List[str]],
    adapter_name: str,
    default_dt_ns: int = 1,
    part_size: Optional[int] = DEFAULT_PART_SIZE,
    baseline_samples: Union[int, Tuple[int, int], None] = None,
    epoch_ns: Optional[int] = None,
    show_progress: bool = False,
    channel_workers: Optional[int] = None,
    profiler: Any = None,
    **kwargs: Any,
) -> RecordsBundle:
    """Full build: per-channel file parse -> parts -> merge.

    ``profiler`` (a Context's) times the phases ``records.decode`` (the
    parse into parts, counting the files' bytes as
    ``records.decode_bytes``), ``records.concat``, ``records.sort`` and
    ``records.gather`` (the merge).

    Channel parallelism: with the native C++ decoder available (the default
    engine), channels parse in a thread pool — ctypes releases the GIL for
    the duration of the C call, so decode scales with cores. Without it,
    parsing is SERIAL across channels: pyarrow's CSV reader is internally
    multithreaded already, and entering it from multiple python worker
    threads segfaults intermittently in this toolchain (observed in the
    vx2730 end-to-end tests). channel_workers overrides either default.
    """
    from waveformanalysis_tpu_torch.formats.adapter import get_adapter

    adapter = get_adapter(adapter_name)

    if adapter_name == "v1725":
        files = []
        seen = set()
        for group in raw_files:
            for f in group or []:
                if f not in seen:
                    seen.add(f)
                    files.append(f)
        bundle = build_records_from_v1725_files(
            files, default_dt_ns=default_dt_ns, reader=adapter.format_reader,
            profiler=profiler,
        )
    else:
        cols = adapter.format_spec.columns
        spec = adapter.format_spec
        b_start, b_end = resolve_baseline_window(
            baseline_samples, cols.samples_start,
            cols.baseline_start, cols.baseline_end,
        )
        # typed native fast path: parse straight into the final record
        # column dtypes (board/channel i16, ts i64, u16 samples, baseline
        # mean folded into the parse). Eligible when samples run to the row
        # end and the engine allows native decode; per-FILE fallback to the
        # generic decoder preserves behavior on anomalous files.
        typed_ok = (
            cols.samples_end is None
            and cols.samples_start >= 3
            and getattr(adapter.format_reader, "parse_engine", "auto")
            in ("auto", "native")
        )
        if typed_ok:
            from waveformanalysis_tpu_torch.native import decode_csv_vx2730_typed

            typed_ok = decode_csv_vx2730_typed(b"", 0) is not None

        def build_channel(args) -> List[RecordsBundle]:
            ch_idx, files = args
            return list(_iter_channel_parts(
                adapter, ch_idx, files,
                typed_ok=typed_ok,
                default_dt_ns=default_dt_ns,
                baseline_samples=baseline_samples,
                part_size=part_size,
                baseline_window=(b_start, b_end),
            ))

        channel_args = list(enumerate(raw_files))
        all_parts: List[RecordsBundle] = []
        if channel_workers is None:
            # threads only when the GIL-releasing native decoder will do
            # the parsing. Should a worker's native parse fail and fall
            # back to pyarrow, _PYARROW_LOCK (formats/vx2730.py) serializes
            # that entry, so the thread-entry segfault hazard stays closed.
            from waveformanalysis_tpu_torch.native import get_lib

            if (get_lib() is not None
                    and hasattr(adapter.format_reader, "_read_native")):
                workers = min(len(channel_args), os.cpu_count() or 1, 8)
            else:
                workers = 1  # serial; see docstring
        else:
            workers = channel_workers
        with _phase(profiler, "records.decode"):
            if profiler is not None:
                profiler.count("records.decode_bytes", sum(
                    os.path.getsize(f) for files in raw_files for f in files or []))
            if workers > 1 and len(channel_args) > 1:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    for parts in pool.map(build_channel, channel_args):
                        all_parts.extend(parts)
            else:
                for args in channel_args:
                    all_parts.extend(build_channel(args))
        bundle = merge_records_parts(all_parts, profiler=profiler)

    if epoch_ns is not None and len(bundle.records):
        ts = np.asarray(bundle.records["timestamp"], dtype=np.int64)
        bundle = RecordsBundle(
            records=bundle.records.with_columns(time=epoch_ns + ts // 1000),
            wave_pool=bundle.wave_pool,
        )
    return bundle


def _iter_channel_parts(
    adapter: Any,
    ch_idx: int,
    files: Optional[List[str]],
    *,
    typed_ok: bool,
    default_dt_ns: int,
    baseline_samples: Any,
    part_size: Optional[int],
    baseline_window: Tuple[int, int],
):
    """Yield one channel's RecordsBundle parts, part_size events at a time.

    Shared by the materialized builder (which collects the parts, possibly
    one channel per thread) and the streaming builder (which spills each
    part to disk as it is yielded). Part boundaries, pids, and per-part
    numerics are identical on both paths by construction.
    """
    if not files:
        return
    spec = adapter.format_spec
    cols = spec.columns
    b_start, b_end = baseline_window
    if typed_ok:
        from waveformanalysis_tpu_torch.native import decode_csv_vx2730_typed

    pid = 0
    buffer: List[Any] = []
    buffered = 0

    def flush() -> Optional[RecordsBundle]:
        nonlocal pid, buffer, buffered
        if not buffer:
            return None
        if typed_ok:
            dec = concat_typed(buffer)
            part = build_part_from_typed(
                dec, default_dt_ns=default_dt_ns,
                normalize_timestamp_to_ps=spec.normalize_timestamp_to_ps,
                pid=pid, sort=False,
            )
        else:
            arr = np.vstack(buffer) if len(buffer) > 1 else buffer[0]
            part = build_part_from_raw_array(
                arr,
                channel_idx=ch_idx,
                default_dt_ns=default_dt_ns,
                cols=cols,
                normalize_timestamp_to_ps=spec.normalize_timestamp_to_ps,
                baseline_samples=baseline_samples,
                pid=pid,
            )
        pid += 1
        buffer, buffered = [], 0
        return part

    for i, f in enumerate(files):
        n_new = 0
        if typed_ok:
            skiprows = (
                spec.header_rows_first_file if i == 0
                else spec.header_rows_other_files
            )
            try:
                raw = Path(f).read_bytes()
            except OSError:
                raw = b""
            dec = decode_csv_vx2730_typed(
                raw, skip_rows=skiprows, delimiter=spec.delimiter,
                samples_start=cols.samples_start,
                baseline_start=b_start, baseline_end=b_end,
            ) if raw else None
            if dec is None:
                # anomalous file: generic decode, convert to typed
                arr = adapter.format_reader.read_file(
                    f, is_first_file=(i == 0)
                )
                if arr.size == 0:
                    continue
                dec = raw_array_to_typed(
                    arr, cols, b_start, b_end, channel_idx=ch_idx
                )
            if len(dec["timestamp"]) == 0:
                continue
            buffer.append(dec)
            n_new = len(dec["timestamp"])
        else:
            arr = adapter.format_reader.read_file(
                f, is_first_file=(i == 0)
            )
            if arr.size == 0:
                continue
            buffer.append(arr)
            n_new = len(arr)
        buffered += n_new
        if part_size and buffered >= part_size:
            part = flush()
            if part is not None:
                yield part
    part = flush()
    if part is not None:
        yield part


def build_records_from_raw_files_streaming(
    raw_files: List[List[str]],
    adapter_name: str,
    default_dt_ns: int = 1,
    part_size: Optional[int] = DEFAULT_PART_SIZE,
    baseline_samples: Union[int, Tuple[int, int], None] = None,
    epoch_ns: Optional[int] = None,
    show_progress: bool = False,
    channel_workers: Optional[int] = None,  # accepted for API parity
    tmp_dir: Optional[str] = None,
    **kwargs: Any,
) -> RecordsBundle:
    """Memory-bounded incremental build: spill parts to disk, merge via memmap.

    Behavioral analog of the reference incremental builder
    (reference: core/processing/records_builder.py:524 — per-channel temp
    part files, then a merge pass). Bit-identical to
    ``build_records_from_raw_files``: the SAME per-channel part generator
    produces the parts (same boundaries, pids, numerics), the SAME
    ``records_sort_order`` orders the merged table, and the gather writes
    the same bytes — only the residency changes:

    - each part's columns + pool spill to ``.npy`` files as soon as they
      are built (peak RSS ~ one part instead of the whole run),
    - the merged wave_pool is a disk-backed ``np.memmap`` filled one part
      at a time (scalar record columns stay in RAM — they are ~2 orders of
      magnitude smaller than the pool),

    so peak resident memory is ~``part_size`` events plus the scalar
    columns, independent of total run size. Channels parse serially by
    design (the point is the memory bound, not decode throughput);
    ``channel_workers`` is accepted for signature parity.
    """
    import os
    import tempfile

    from waveformanalysis_tpu_torch.formats.adapter import get_adapter

    adapter = get_adapter(adapter_name)

    if adapter_name == "v1725":
        # V1725 runs arrive as one compact binary blob per board; the
        # header-scan builder is already near-minimal in residency. Ledgered
        # in docs/PARITY.md (streaming ingest covers the CSV family).
        return build_records_from_raw_files(
            raw_files, adapter_name, default_dt_ns=default_dt_ns,
            part_size=part_size, baseline_samples=baseline_samples,
            epoch_ns=epoch_ns, show_progress=show_progress,
        )

    cols = adapter.format_spec.columns
    b_start, b_end = resolve_baseline_window(
        baseline_samples, cols.samples_start,
        cols.baseline_start, cols.baseline_end,
    )
    typed_ok = (
        cols.samples_end is None
        and cols.samples_start >= 3
        and getattr(adapter.format_reader, "parse_engine", "auto")
        in ("auto", "native")
    )
    if typed_ok:
        from waveformanalysis_tpu_torch.native import decode_csv_vx2730_typed

        typed_ok = decode_csv_vx2730_typed(b"", 0) is not None

    own_tmp = tmp_dir is None
    tmp_root = tempfile.mkdtemp(prefix="wfa_records_stream_") \
        if own_tmp else tmp_dir
    os.makedirs(tmp_root, exist_ok=True)

    # ---- phase 1: build + spill parts, one resident at a time ----
    spilled: List[dict] = []  # per part: column paths + row/pool sizes
    for ch_idx, files in enumerate(raw_files):
        for part in _iter_channel_parts(
            adapter, ch_idx, files,
            typed_ok=typed_ok,
            default_dt_ns=default_dt_ns,
            baseline_samples=baseline_samples,
            part_size=part_size,
            baseline_window=(b_start, b_end),
        ):
            idx = len(spilled)
            entry = {"n": len(part.records),
                     "pool_size": int(part.wave_pool.size),
                     "cols": {}}
            host = part.records.to_host()
            for name, col in host.columns.items():
                p = os.path.join(tmp_root, f"part{idx}_{name}.npy")
                np.save(p, np.asarray(col))
                entry["cols"][name] = p
            p = os.path.join(tmp_root, f"part{idx}_pool.npy")
            np.save(p, part.wave_pool)
            entry["pool"] = p
            spilled.append(entry)
            del part, host

    if not spilled:
        return empty_bundle()

    # ---- phase 2: merge. Scalar columns concatenate in RAM (small); the
    # pool gathers part-by-part into a disk-backed memmap. ----
    def load_col(entry, name):
        return np.load(entry["cols"][name], mmap_mode="r")

    col_names = list(spilled[0]["cols"])
    merged = {}
    pool_bases = np.concatenate(
        [[0], np.cumsum([e["pool_size"] for e in spilled])[:-1]]
    ).astype(np.int64)
    for name in col_names:
        arrs = [np.asarray(load_col(e, name)) for e in spilled]
        if name == "wave_offset":
            arrs = [a.astype(np.int64) + base
                    for a, base in zip(arrs, pool_bases)]
        merged[name] = np.concatenate(arrs)
        del arrs
    part_ids = np.repeat(
        np.arange(len(spilled), dtype=np.int64),
        [e["n"] for e in spilled],
    )

    records = Table(merged, schema=RECORDS_SCHEMA)
    order = records_sort_order(records)
    records = records[order]
    part_ids = part_ids[order]

    lengths = np.asarray(records["event_length"], dtype=np.int64)
    old_offsets = np.asarray(records["wave_offset"], dtype=np.int64)
    total = int(lengths.sum())
    new_offsets = (
        np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
        if len(lengths) else np.zeros(0, np.int64)
    )

    pool_path = os.path.join(tmp_root, "wave_pool.dat")
    pool_out = np.memmap(pool_path, dtype=np.uint16, mode="w+",
                         shape=(max(total, 1),))
    # index-array gather costs 24 B/sample transient (3 int64 arrays per
    # sample) vs 2 B/sample of pool — chunk each part's gather by a sample
    # budget and use int32 indices when addresses fit, so the transient
    # stays bounded regardless of part size
    gather_budget = 1 << 21  # samples per gather chunk (~25 MB int32 peak)
    for i, entry in enumerate(spilled):
        sel = np.nonzero(part_ids == i)[0]
        if not len(sel):
            continue
        lens = lengths[sel]
        t = int(lens.sum())
        if t == 0:
            continue
        part_pool = np.load(entry["pool"], mmap_mode="r")
        idx_dt = (np.int32
                  if max(total, entry["pool_size"]) < np.iinfo(np.int32).max
                  else np.int64)
        ends = np.cumsum(lens)
        starts = ends - lens
        row = 0
        while row < len(sel):
            stop = int(np.searchsorted(
                ends, ends[row] - lens[row] + gather_budget, side="left"
            )) + 1
            stop = min(max(stop, row + 1), len(sel))
            rows = slice(row, stop)
            lens_c = lens[rows]
            tc = int(lens_c.sum())
            if tc:
                base_c = starts[rows] - starts[row]
                ramp = np.arange(tc, dtype=idx_dt) - np.repeat(
                    base_c.astype(idx_dt), lens_c
                )
                src_idx = np.repeat(
                    (old_offsets[sel[rows]] - pool_bases[i]).astype(idx_dt),
                    lens_c,
                ) + ramp
                out_idx = np.repeat(
                    new_offsets[sel[rows]].astype(idx_dt), lens_c
                ) + ramp
                del ramp
                pool_out[out_idx] = part_pool[src_idx]
                del src_idx, out_idx
            row = stop
        del part_pool, lens, ends, starts, sel
        os.remove(entry["pool"])
    pool_out.flush()
    if total == 0:
        pool_view = np.zeros(0, dtype=np.uint16)
    elif total < pool_out.size:
        pool_view = pool_out[:total]
    else:
        pool_view = pool_out

    records = records.with_columns(
        wave_offset=new_offsets,
        record_id=np.arange(len(records), dtype=np.int64),
    )
    for entry in spilled:
        for p in entry["cols"].values():
            try:
                os.remove(p)
            except OSError:
                pass

    bundle = RecordsBundle(records=records, wave_pool=pool_view)
    if epoch_ns is not None and len(bundle.records):
        ts = np.asarray(bundle.records["timestamp"], dtype=np.int64)
        bundle = RecordsBundle(
            records=bundle.records.with_columns(time=epoch_ns + ts // 1000),
            wave_pool=bundle.wave_pool,
        )
    return bundle


def apply_records_polarity(bundle: RecordsBundle, context: Any, run_id: str) -> RecordsBundle:
    """Apply per-channel polarity metadata to records
    (reference: records.py:40-62, vectorized per unique channel here)."""
    from waveformanalysis_tpu_torch.hardware import get_polarity
    from waveformanalysis_tpu_torch.dtypes.schema import POLARITY_CODES

    rec = bundle.records
    n = len(rec)
    if n == 0:
        return bundle
    boards = np.asarray(rec["board"])
    channels = np.asarray(rec["channel"])
    pol = np.asarray(rec["polarity"], dtype=np.int8).copy()
    for hw, idx in group_indices_by_hardware_channel(boards, channels).items():
        p = get_polarity(context, run_id, hw.board, hw.channel)
        pol[idx] = POLARITY_CODES.get(p, 0)
    return RecordsBundle(records=rec.with_columns(polarity=pol), wave_pool=bundle.wave_pool)
