"""Chunk model and time-interval algebra.

Behavioral rebuild of the reference chunk layer
(reference: waveform_analysis/core/processing/chunk.py:78,262-1341): a Chunk
wraps time-windowed data with [start, end) boundaries validated at
construction; pure functions implement endtime computation, monotonic/overlap
checks, time-range selection/clipping, splitting (by time/count/breaks),
merging, rechunking, and boundary/continuity validation.

Port of ``waveformanalysis_tpu/dtypes/chunk.py``. Every function works on
either a :class:`~waveformanalysis_tpu_torch.dtypes.table.Table` (NumPy or
``torch.Tensor`` columns) or a NumPy structured array, via a tiny accessor
shim. The time algebra reads its columns on the host (``device.to_numpy``,
so a column on the card is copied, never refused); row selection and
concatenation (``Table.__getitem__``, ``Table.concatenate``) keep a tensor
column a tensor on its device. Field-name
fallbacks match the reference: ``time``->``timestamp``,
``length``->``event_length``.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, Generator, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from waveformanalysis_tpu_torch.device import to_numpy
from waveformanalysis_tpu_torch.dtypes.table import Table

TIME_FIELD = "time"
DT_FIELD = "dt"
LENGTH_FIELD = "length"
ENDTIME_FIELD = "endtime"
CHANNEL_FIELD = "channel"
TIMESTAMP_FIELD = "timestamp"
EVENT_LENGTH_FIELD = "event_length"

DEFAULT_CHUNK_SIZE = 500_000
DEFAULT_BREAK_THRESHOLD_PS = 10_000_000_000_000  # 10 us in ps


# --------------------------------------------------------------------------
# Data accessor shim: Table | structured ndarray
# --------------------------------------------------------------------------

def _field_names(data: Any) -> Tuple[str, ...]:
    if isinstance(data, Table):
        return data.field_names
    names = getattr(getattr(data, "dtype", None), "names", None)
    if names is None:
        raise TypeError("Data must be a Table or a structured numpy array")
    return tuple(names)


def _has(data: Any, name: str) -> bool:
    return name in _field_names(data)


def _col(data: Any, name: str) -> np.ndarray:
    return to_numpy(data[name])


def _nrows(data: Any) -> int:
    return len(data)


def _take(data: Any, idx: Any) -> Any:
    return data[idx]


def _concat(parts: List[Any]) -> Any:
    if not parts:
        return np.array([])
    if isinstance(parts[0], Table):
        return Table.concatenate(parts)
    return np.concatenate(parts)


def _copy(data: Any) -> Any:
    if isinstance(data, Table):
        return Table({k: np.array(v, copy=True) for k, v in data.to_host().columns.items()},
                     schema=data.schema, validate=False)
    return data.copy()


def resolve_time_field(data: Any, time_field: str = TIME_FIELD) -> str:
    """Field-name fallback: time -> timestamp."""
    if _has(data, time_field):
        return time_field
    if time_field == TIME_FIELD and _has(data, TIMESTAMP_FIELD):
        return TIMESTAMP_FIELD
    return time_field


def resolve_length_field(data: Any, length_field: str = LENGTH_FIELD) -> str:
    """Field-name fallback: length -> event_length."""
    if _has(data, length_field):
        return length_field
    if length_field == LENGTH_FIELD and _has(data, EVENT_LENGTH_FIELD):
        return EVENT_LENGTH_FIELD
    return length_field


# --------------------------------------------------------------------------
# Validation result containers
# --------------------------------------------------------------------------

@dataclass
class ValidationResult:
    is_valid: bool = True
    errors: List[str] = dc_field(default_factory=list)
    warnings: List[str] = dc_field(default_factory=list)
    stats: Dict[str, Any] = dc_field(default_factory=dict)

    def __bool__(self) -> bool:
        return self.is_valid


@dataclass
class ChunkInfo:
    start_time: int = 0
    end_time: int = 0
    n_records: int = 0
    chunk_i: int = 0


# --------------------------------------------------------------------------
# Endtime algebra
# --------------------------------------------------------------------------

def compute_endtime(
    data: Any,
    time_field: str = TIME_FIELD,
    dt_field: str = DT_FIELD,
    length_field: str = LENGTH_FIELD,
    dt: Optional[float] = None,
) -> np.ndarray:
    """endtime = time + dt * length (int64, in the time field's unit)."""
    tf = resolve_time_field(data, time_field)
    lf = resolve_length_field(data, length_field)
    if not _has(data, tf):
        raise KeyError(f"Missing time field '{tf}'")
    if not _has(data, lf):
        raise KeyError(f"Missing length field '{lf}'")
    time = _col(data, tf).astype(np.int64)
    length = _col(data, lf).astype(np.int64)
    if dt is None:
        if not _has(data, dt_field):
            raise KeyError(f"Missing dt field '{dt_field}' and no fixed dt given")
        dt_values = _col(data, dt_field).astype(np.int64)
        endtime = time + dt_values * length
    else:
        endtime = time + (np.asarray(dt, dtype=np.float64) * length)
    return endtime.astype(np.int64)


def get_endtime(
    data: Any,
    time_field: str = TIME_FIELD,
    endtime_field: str = ENDTIME_FIELD,
    dt_field: str = DT_FIELD,
    length_field: str = LENGTH_FIELD,
    dt: Optional[float] = None,
) -> np.ndarray:
    """Endtime from the endtime field if present, else computed; records with
    no length/dt information are treated as instantaneous."""
    if _has(data, endtime_field):
        return _col(data, endtime_field)
    tf = resolve_time_field(data, time_field)
    lf = resolve_length_field(data, length_field)
    if not _has(data, lf):
        return _col(data, tf)
    if dt is None and not _has(data, dt_field):
        return _col(data, tf)
    return compute_endtime(data, time_field=tf, dt_field=dt_field, length_field=lf, dt=dt)


def add_endtime_field(data: Any, inplace: bool = False) -> Any:
    """Attach/refresh an explicit endtime column."""
    endtime = compute_endtime(data)
    if isinstance(data, Table):
        if inplace and ENDTIME_FIELD not in data:
            raise ValueError(f"Cannot modify inplace: '{ENDTIME_FIELD}' not present")
        return data.with_columns(endtime=endtime)
    if ENDTIME_FIELD in data.dtype.names:
        data[ENDTIME_FIELD] = endtime
        return data
    if inplace:
        raise ValueError(f"Cannot modify inplace: '{ENDTIME_FIELD}' field not in dtype")
    new_dtype = np.dtype(data.dtype.descr + [(ENDTIME_FIELD, "<i8")])
    result = np.empty(len(data), dtype=new_dtype)
    for name in data.dtype.names:
        result[name] = data[name]
    result[ENDTIME_FIELD] = endtime
    return result


def validate_endtime(data: Any, tolerance_ns: int = 0) -> ValidationResult:
    result = ValidationResult()
    if not _has(data, ENDTIME_FIELD):
        result.is_valid = False
        result.errors.append(f"Missing '{ENDTIME_FIELD}' field")
        return result
    expected = compute_endtime(data)
    actual = _col(data, ENDTIME_FIELD).astype(np.int64)
    diff = np.abs(actual - expected)
    n_mismatch = int(np.sum(diff > tolerance_ns))
    if n_mismatch > 0:
        result.is_valid = False
        result.errors.append(
            f"Endtime mismatch: {n_mismatch}/{_nrows(data)} records differ "
            f"by up to {int(np.max(diff))}ns"
        )
    result.stats = {
        "n_records": _nrows(data),
        "n_mismatch": n_mismatch,
        "max_diff_ns": int(np.max(diff)) if len(diff) else 0,
    }
    return result


# --------------------------------------------------------------------------
# Monotonicity / overlap / sortedness checks
# --------------------------------------------------------------------------

def check_monotonic(data: Any, field: str = TIME_FIELD, strict: bool = False) -> ValidationResult:
    result = ValidationResult()
    n = _nrows(data)
    if n <= 1:
        result.stats = {"n_records": n, "is_sorted": True}
        return result
    f = resolve_time_field(data, field)
    if not _has(data, f):
        result.is_valid = False
        result.errors.append(f"Field '{field}' not found")
        return result
    vals = _col(data, f)
    diffs = np.diff(vals.astype(np.int64))
    bad = diffs <= 0 if strict else diffs < 0
    n_bad = int(np.sum(bad))
    if n_bad > 0:
        result.is_valid = False
        first = int(np.argmax(bad))
        result.errors.append(
            f"{n_bad} non-monotonic steps in '{f}' (first at index {first})"
        )
    result.stats = {"n_records": n, "n_violations": n_bad, "is_sorted": n_bad == 0}
    return result


def check_overlap(
    data: Any,
    time_field: str = TIME_FIELD,
    dt: Optional[float] = None,
) -> ValidationResult:
    """Check that time-sorted records do not overlap (endtime[i] <= time[i+1])."""
    result = ValidationResult()
    n = _nrows(data)
    if n <= 1:
        result.stats = {"n_records": n, "n_overlaps": 0}
        return result
    tf = resolve_time_field(data, time_field)
    time = _col(data, tf).astype(np.int64)
    endtime = np.asarray(get_endtime(data, time_field=tf, dt=dt)).astype(np.int64)
    overlaps = endtime[:-1] > time[1:]
    n_overlaps = int(np.sum(overlaps))
    if n_overlaps > 0:
        result.is_valid = False
        result.errors.append(f"{n_overlaps} overlapping record pairs")
    result.stats = {"n_records": n, "n_overlaps": n_overlaps}
    return result


def is_sorted_by_time(data: Any, time_field: str = TIME_FIELD) -> bool:
    return check_monotonic(data, field=time_field, strict=False).is_valid


def sort_by_time(data: Any, time_field: str = TIME_FIELD) -> Any:
    tf = resolve_time_field(data, time_field)
    order = np.argsort(_col(data, tf), kind="stable")
    return _take(data, order)


def concat_sorted(parts: List[Any], time_field: str = TIME_FIELD) -> Any:
    """Concatenate chunks and re-sort by time (stable)."""
    merged = _concat([p for p in parts if _nrows(p) > 0] or parts)
    if _nrows(merged) == 0:
        return merged
    return sort_by_time(merged, time_field)


# --------------------------------------------------------------------------
# Selection / clipping
# --------------------------------------------------------------------------

def select_time_range(
    data: Any,
    start: Optional[int] = None,
    end: Optional[int] = None,
    strict: bool = False,
    time_field: str = TIME_FIELD,
    endtime_field: str = ENDTIME_FIELD,
    dt_field: str = DT_FIELD,
    length_field: str = LENGTH_FIELD,
    dt: Optional[float] = None,
) -> Any:
    """Select records in [start, end).

    strict=True keeps only records fully inside the window; strict=False keeps
    any record intersecting it.
    """
    if _nrows(data) == 0:
        return data
    tf = resolve_time_field(data, time_field)
    time = _col(data, tf).astype(np.int64)
    endtime = np.asarray(
        get_endtime(data, time_field=tf, endtime_field=endtime_field,
                    dt_field=dt_field, length_field=length_field, dt=dt)
    ).astype(np.int64)
    mask = np.ones(len(time), dtype=bool)
    if strict:
        if start is not None:
            mask &= time >= start
        if end is not None:
            mask &= endtime <= end
    else:
        if start is not None:
            # endtime > start catches intervals reaching into the window;
            # time >= start additionally keeps zero-duration rows (tables
            # without length/dt fields have endtime == time) sitting exactly
            # on the window start
            mask &= (endtime > start) | (time >= start)
        if end is not None:
            mask &= time < end
    return _take(data, mask)


def clip_to_time_range(
    data: Any,
    start: Optional[int] = None,
    end: Optional[int] = None,
) -> Any:
    """Clip records to [start, end), adjusting time/length/endtime.

    Requires explicit time/dt/length fields (no fallbacks), like the
    reference's waveform-clipping path.
    """
    if _nrows(data) == 0:
        return data
    result = select_time_range(data, start, end, strict=False)
    if _nrows(result) == 0:
        return result

    time = _col(result, TIME_FIELD).astype(np.int64)
    dt = _col(result, DT_FIELD).astype(np.int64)
    length = _col(result, LENGTH_FIELD).astype(np.int64)
    endtime = time + dt * length

    needs_clipping = bool(start is not None and np.any(time < start))
    if not needs_clipping and end is not None:
        needs_clipping = bool(np.any(endtime > end))
    if not needs_clipping:
        return result

    result = _copy(result)
    time = _col(result, TIME_FIELD).astype(np.int64)
    dt = _col(result, DT_FIELD).astype(np.int64)
    length = _col(result, LENGTH_FIELD).astype(np.int64)

    if start is not None:
        clip_start = time < start
        if np.any(clip_start):
            time_diff = start - time[clip_start]
            skip = (time_diff + dt[clip_start] - 1) // dt[clip_start]
            skip = np.minimum(skip, length[clip_start])
            new_time = time.copy()
            new_length = length.copy()
            new_time[clip_start] = time[clip_start] + skip * dt[clip_start]
            new_length[clip_start] = length[clip_start] - skip
            result = _set_col(result, TIME_FIELD, new_time)
            result = _set_col(result, LENGTH_FIELD, new_length.astype(length.dtype))
            time, length = new_time, new_length

    if end is not None:
        endtime = time + dt * length
        clip_end = endtime > end
        if np.any(clip_end):
            new_endtime = np.minimum(endtime[clip_end], end)
            new_length = length.copy()
            new_length[clip_end] = (new_endtime - time[clip_end]) // dt[clip_end]
            result = _set_col(result, LENGTH_FIELD, new_length.astype(length.dtype))
            length = new_length

    valid = _col(result, LENGTH_FIELD) > 0
    result = _take(result, valid)
    if _has(result, ENDTIME_FIELD) and _nrows(result) > 0:
        result = _set_col(result, ENDTIME_FIELD, compute_endtime(result))
    return result


def _set_col(data: Any, name: str, values: np.ndarray) -> Any:
    if isinstance(data, Table):
        return data.with_columns(**{name: values})
    data[name] = values
    return data


# --------------------------------------------------------------------------
# Splitting / merging / rechunking
# --------------------------------------------------------------------------

def split_by_time(
    data: Any,
    chunk_duration_ns: int,
    start_time: Optional[int] = None,
) -> Generator[Tuple[Any, ChunkInfo], None, None]:
    """Split into fixed-duration windows (records may appear in multiple
    windows if they straddle boundaries — intersect semantics)."""
    if _nrows(data) == 0:
        return
    tf = resolve_time_field(data)
    time = _col(data, tf)
    if start_time is None:
        start_time = int(np.min(time))
    endtime = np.asarray(get_endtime(data))
    max_endtime = int(np.max(endtime))
    chunk_i = 0
    current = int(start_time)
    while current < max_endtime:
        nxt = current + chunk_duration_ns
        chunk_data = select_time_range(data, current, nxt, strict=False)
        if _nrows(chunk_data) > 0:
            info = ChunkInfo(
                start_time=current,
                end_time=min(nxt, int(np.max(np.asarray(get_endtime(chunk_data))))),
                n_records=_nrows(chunk_data),
                chunk_i=chunk_i,
            )
            yield chunk_data, info
            chunk_i += 1
        current = nxt


def split_by_count(
    data: Any,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
) -> Generator[Tuple[Any, ChunkInfo], None, None]:
    """Split time-sorted data into fixed-size record chunks."""
    n = _nrows(data)
    if n == 0:
        return
    tf = resolve_time_field(data)
    n_chunks = (n + chunk_size - 1) // chunk_size
    for chunk_i in range(n_chunks):
        sl = slice(chunk_i * chunk_size, min((chunk_i + 1) * chunk_size, n))
        chunk_data = _take(data, sl)
        if _nrows(chunk_data) == 0:
            continue
        info = ChunkInfo(
            start_time=int(np.min(_col(chunk_data, tf))),
            end_time=int(np.max(np.asarray(get_endtime(chunk_data)))),
            n_records=_nrows(chunk_data),
            chunk_i=chunk_i,
        )
        yield chunk_data, info


def split_by_breaks(
    data: Any,
    break_threshold_ps: int = DEFAULT_BREAK_THRESHOLD_PS,
    min_chunk_size: int = 1,
    time_field: str = TIME_FIELD,
    dt: Optional[float] = None,
) -> Generator[Tuple[Any, ChunkInfo], None, None]:
    """Split time-sorted data at gaps larger than the break threshold."""
    if _nrows(data) == 0:
        return
    tf = resolve_time_field(data, time_field)
    time = _col(data, tf).astype(np.int64)
    endtime = np.asarray(get_endtime(data, time_field=tf, dt=dt)).astype(np.int64)
    gaps = time[1:] - endtime[:-1]
    breaks = np.where(gaps > break_threshold_ps)[0] + 1
    bounds = np.concatenate([[0], breaks, [len(time)]])
    chunk_i = 0
    for i in range(len(bounds) - 1):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        if hi - lo < min_chunk_size:
            continue
        chunk_data = _take(data, slice(lo, hi))
        info = ChunkInfo(
            start_time=int(np.min(_col(chunk_data, tf))),
            end_time=int(np.max(np.asarray(get_endtime(chunk_data, time_field=tf, dt=dt)))),
            n_records=_nrows(chunk_data),
            chunk_i=chunk_i,
        )
        yield chunk_data, info
        chunk_i += 1


def find_break_indices(
    data: Any,
    break_threshold_ps: int = DEFAULT_BREAK_THRESHOLD_PS,
    time_field: str = TIME_FIELD,
) -> np.ndarray:
    """Indices where a new segment starts (gap > threshold). Always includes 0."""
    if _nrows(data) == 0:
        return np.zeros(0, dtype=np.int64)
    tf = resolve_time_field(data, time_field)
    time = _col(data, tf).astype(np.int64)
    endtime = np.asarray(get_endtime(data, time_field=tf)).astype(np.int64)
    gaps = time[1:] - endtime[:-1]
    breaks = np.where(gaps > break_threshold_ps)[0] + 1
    return np.concatenate([[0], breaks]).astype(np.int64)


def merge_chunks(chunks: Iterable[Any], sort: bool = True) -> Any:
    parts = list(chunks)
    if not parts:
        return np.array([])
    merged = _concat(parts)
    if sort and _nrows(merged) > 0 and _has(merged, TIME_FIELD):
        merged = _take(merged, np.argsort(_col(merged, TIME_FIELD), kind="stable"))
    return merged


def rechunk(
    chunks: Iterator[Tuple[Any, ChunkInfo]],
    target_size: int = DEFAULT_CHUNK_SIZE,
    max_size: Optional[int] = None,
) -> Generator[Tuple[Any, ChunkInfo], None, None]:
    """Re-buffer irregular chunks toward a target size."""
    if max_size is None:
        max_size = target_size * 2
    buffer: List[Any] = []
    buffer_size = 0
    chunk_i = 0
    tf = None

    def flush():
        nonlocal buffer, buffer_size, chunk_i
        if not buffer:
            return None
        merged = _concat(buffer) if len(buffer) > 1 else buffer[0]
        t = resolve_time_field(merged)
        info = ChunkInfo(
            start_time=int(np.min(_col(merged, t))),
            end_time=int(np.max(np.asarray(get_endtime(merged)))),
            n_records=_nrows(merged),
            chunk_i=chunk_i,
        )
        chunk_i += 1
        buffer = []
        buffer_size = 0
        return merged, info

    for data, _info in chunks:
        if _nrows(data) == 0:
            continue
        if _nrows(data) >= max_size:
            out = flush()
            if out is not None:
                yield out
            for sub, sub_info in split_by_count(data, target_size):
                sub_info.chunk_i = chunk_i
                chunk_i += 1
                yield sub, sub_info
            continue
        buffer.append(data)
        buffer_size += _nrows(data)
        if buffer_size >= target_size:
            out = flush()
            if out is not None:
                yield out
    out = flush()
    if out is not None:
        yield out


def rechunk_to_boundaries(
    chunks: Iterator[Tuple[Any, ChunkInfo]],
    boundary_times: np.ndarray,
) -> Generator[Tuple[Any, ChunkInfo], None, None]:
    """Re-chunk a stream so outputs align to given sorted time boundaries."""
    boundary_times = np.sort(np.asarray(boundary_times))
    if len(boundary_times) == 0:
        yield from chunks
        return

    buffer: List[Any] = []
    b_idx = 0
    chunk_i = 0

    def emit(part: Any) -> Optional[Tuple[Any, ChunkInfo]]:
        nonlocal chunk_i
        if _nrows(part) == 0:
            return None
        tf = resolve_time_field(part)
        info = ChunkInfo(
            start_time=int(np.min(_col(part, tf))),
            end_time=int(np.max(np.asarray(get_endtime(part)))),
            n_records=_nrows(part),
            chunk_i=chunk_i,
        )
        chunk_i += 1
        return part, info

    for data, _info in chunks:
        if _nrows(data) == 0:
            continue
        buffer.append(data)
        merged = _concat(buffer) if len(buffer) > 1 else buffer[0]
        max_endtime = int(np.max(np.asarray(get_endtime(merged))))
        while b_idx < len(boundary_times) and max_endtime >= boundary_times[b_idx]:
            boundary = int(boundary_times[b_idx])
            before = select_time_range(merged, end=boundary, strict=False)
            after = select_time_range(merged, start=boundary, strict=False)
            out = emit(before)
            if out is not None:
                yield out
            merged = after
            buffer = [merged] if _nrows(merged) > 0 else []
            b_idx += 1
            if _nrows(merged) == 0:
                break
            max_endtime = int(np.max(np.asarray(get_endtime(merged))))

    if buffer:
        merged = _concat(buffer) if len(buffer) > 1 else buffer[0]
        out = emit(merged)
        if out is not None:
            yield out


# --------------------------------------------------------------------------
# Boundary / continuity validation
# --------------------------------------------------------------------------

def check_chunk_boundaries(
    data: Any,
    chunk_start: int,
    chunk_end: int,
    time_field: str = TIME_FIELD,
    dt: Optional[float] = None,
) -> ValidationResult:
    """No record may start before chunk_start or end after chunk_end."""
    result = ValidationResult()
    if _nrows(data) == 0:
        result.stats = {"n_records": 0, "violations": 0}
        return result
    tf = resolve_time_field(data, time_field)
    time = _col(data, tf).astype(np.int64)
    endtime = np.asarray(get_endtime(data, time_field=tf, dt=dt)).astype(np.int64)
    before = time < chunk_start
    after = endtime > chunk_end
    n_before, n_after = int(np.sum(before)), int(np.sum(after))
    if n_before:
        result.is_valid = False
        result.errors.append(
            f"{n_before} records start before chunk boundary "
            f"(earliest: {int(np.min(time[before]))} < {chunk_start})"
        )
    if n_after:
        result.is_valid = False
        result.errors.append(
            f"{n_after} records extend beyond chunk boundary "
            f"(latest: {int(np.max(endtime[after]))} > {chunk_end})"
        )
    result.stats = {
        "n_records": _nrows(data),
        "n_before_start": n_before,
        "n_after_end": n_after,
        "violations": n_before + n_after,
    }
    return result


def check_chunk_continuity(
    chunks: List[Tuple[Any, ChunkInfo]],
    allow_gaps: bool = False,
    max_gap_ns: int = 0,
) -> ValidationResult:
    """Adjacent chunks must not overlap; gaps are optional per policy."""
    result = ValidationResult()
    if len(chunks) <= 1:
        result.stats = {"n_chunks": len(chunks), "n_gaps": 0, "n_overlaps": 0}
        return result
    infos = [info for _, info in chunks]
    n_gaps = n_overlaps = max_gap = 0
    for i in range(len(infos) - 1):
        gap = infos[i + 1].start_time - infos[i].end_time
        if gap < 0:
            n_overlaps += 1
            result.errors.append(
                f"Chunks {i} and {i + 1} overlap by {-gap}ns "
                f"(chunk {i} ends at {infos[i].end_time}, "
                f"chunk {i + 1} starts at {infos[i + 1].start_time})"
            )
        elif gap > max_gap_ns:
            n_gaps += 1
            max_gap = max(max_gap, gap)
            if not allow_gaps:
                result.errors.append(
                    f"Gap of {gap}ns between chunks {i} and {i + 1} "
                    f"(exceeds max allowed {max_gap_ns}ns)"
                )
    if n_overlaps > 0 or (not allow_gaps and n_gaps > 0):
        result.is_valid = False
    if n_gaps > 0 and allow_gaps:
        result.warnings.append(f"Found {n_gaps} gaps between chunks (max: {max_gap}ns)")
    result.stats = {
        "n_chunks": len(chunks),
        "n_gaps": n_gaps,
        "n_overlaps": n_overlaps,
        "max_gap_ns": max_gap,
    }
    return result


# --------------------------------------------------------------------------
# Chunk object
# --------------------------------------------------------------------------

class Chunk:
    """A block of time-windowed data with validated [start, end) boundaries."""

    def __init__(
        self,
        data: Any,
        start: int,
        end: int,
        run_id: str = "unknown",
        data_type: str = "raw",
        data_kind: str = "waveforms",
        time_field: str = TIME_FIELD,
        dt_field: str = DT_FIELD,
        length_field: str = LENGTH_FIELD,
        endtime_field: str = ENDTIME_FIELD,
        dt: Optional[float] = None,
        metadata: Optional[dict] = None,
    ) -> None:
        self.data = data
        self.start = int(start)
        self.end = int(end)
        self.run_id = run_id
        self.data_type = data_type
        self.data_kind = data_kind
        self.time_field = time_field
        self.dt_field = dt_field
        self.length_field = length_field
        self.endtime_field = endtime_field
        self.dt = dt
        self.metadata = metadata or {}

        if _nrows(data) > 0:
            tf = resolve_time_field(data, self.time_field)
            lf = resolve_length_field(data, self.length_field)
            time_values = _col(data, tf)
            data_start = int(np.min(time_values))
            if data_start < self.start:
                raise ValueError(
                    f"Chunk data starts at {data_start}, before chunk start {self.start}"
                )
            data_end = int(np.max(np.asarray(get_endtime(
                data, time_field=tf, endtime_field=self.endtime_field,
                dt_field=self.dt_field, length_field=lf, dt=self.dt,
            ))))
            if data_end > self.end:
                raise ValueError(
                    f"Chunk data ends at {data_end}, after chunk end {self.end}"
                )

    def __len__(self) -> int:
        return _nrows(self.data)

    @property
    def duration(self) -> int:
        return self.end - self.start

    @property
    def nbytes(self) -> int:
        data = self.data
        if isinstance(data, Table):
            return int(sum(np.asarray(v).nbytes for v in data.to_host().columns.values()))
        return int(data.nbytes)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"Chunk({self.run_id}.{self.data_type}: "
            f"{self.start} - {self.end}, {len(self)} items)"
        )

    def split(self, t: int) -> Tuple["Chunk", "Chunk"]:
        """Split at time t into (records with time < t, the rest)."""
        t = max(min(t, self.end), self.start)
        tf = resolve_time_field(self.data, self.time_field)
        mask = _col(self.data, tf) < t
        kwargs = dict(
            run_id=self.run_id, data_type=self.data_type, data_kind=self.data_kind,
            time_field=self.time_field, dt_field=self.dt_field,
            length_field=self.length_field, endtime_field=self.endtime_field,
            dt=self.dt, metadata=self.metadata,
        )
        return (
            Chunk(_take(self.data, mask), self.start, t, **kwargs),
            Chunk(_take(self.data, ~mask), t, self.end, **kwargs),
        )


def time_to_samples(time_ns: int, dt_ns: int) -> int:
    """Time -> sample count (floor division, reference chunk.py:1334)."""
    return time_ns // dt_ns


def samples_to_time(samples: int, dt_ns: int) -> int:
    """Sample count -> time in ns (reference chunk.py:1340)."""
    return samples * dt_ns
