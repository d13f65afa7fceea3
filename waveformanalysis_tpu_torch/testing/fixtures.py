"""Public testing fixtures for downstream plugin authors.

Behavioral analog of the reference public fixture module
(reference: waveform_analysis/testing/fixtures.py:19-57):
``make_fake_st_waveforms`` builds synthetic structured waveforms with known
pulses; ``make_tiny_context`` returns a Context with those waveforms injected
so feature plugins can be unit-tested without DAQ decode.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from waveformanalysis_tpu_torch.dtypes.schema import ST_WAVEFORM_SCHEMA, create_record_dtype
from waveformanalysis_tpu_torch.dtypes.table import Table


def make_fake_st_waveforms(
    n_events: int = 16,
    wave_length: int = 128,
    n_channels: int = 2,
    baseline: float = 1000.0,
    pulse_height: int = 200,
    pulse_start: int = 50,
    pulse_width: int = 10,
    polarity: str = "negative",
    noise_rms: float = 0.0,
    dt_ns: int = 2,
    seed: int = 0,
    as_table: bool = False,
) -> Any:
    """Synthetic st_waveforms with a square pulse per event.

    Returns a NumPy structured array (reference layout) by default, or a
    Table when ``as_table=True``.
    """
    rng = np.random.default_rng(seed)
    dtype = create_record_dtype(wave_length)
    arr = np.zeros(n_events, dtype=dtype)
    arr["baseline"] = baseline
    arr["polarity"] = polarity
    arr["timestamp"] = np.arange(n_events, dtype=np.int64) * 10_000_000  # ps
    arr["record_id"] = np.arange(n_events)
    arr["dt"] = dt_ns
    arr["event_length"] = wave_length
    arr["board"] = 0
    arr["channel"] = np.arange(n_events) % n_channels

    waves = np.full((n_events, wave_length), baseline, dtype=np.float64)
    if noise_rms > 0:
        waves += rng.normal(0, noise_rms, size=waves.shape)
    sign = 1.0 if polarity == "positive" else -1.0
    waves[:, pulse_start : pulse_start + pulse_width] += sign * pulse_height
    arr["wave"] = np.clip(np.round(waves), -32768, 32767).astype(np.int16)

    if as_table:
        return Table.from_numpy(arr, schema=ST_WAVEFORM_SCHEMA)
    return arr


def st_waveforms_from_waves(
    waves: np.ndarray,
    baseline: float = 1000.0,
    polarity: str = "positive",
    dt_ns: int = 2,
) -> np.ndarray:
    """st_waveforms records around an (n, L) int16 wave matrix.

    Every event is full length, channel ``i % 2``, record_id ``i`` and
    timestamp ``i * 10^7`` ps (the layout of ``make_fake_st_waveforms``),
    with one fixed baseline and polarity.
    """
    n, L = waves.shape
    arr = np.zeros(n, dtype=create_record_dtype(L))
    arr["baseline"] = baseline
    arr["polarity"] = polarity
    arr["timestamp"] = np.arange(n, dtype=np.int64) * 10_000_000
    arr["record_id"] = np.arange(n)
    arr["dt"] = dt_ns
    arr["event_length"] = L
    arr["channel"] = (np.arange(n) % 2).astype(np.int16)
    arr["wave"] = waves
    return arr


def make_synthetic_vx2730_run(
    data_root: str,
    run_name: str = "run_001",
    n_channels: int = 2,
    n_files_per_channel: int = 1,
    n_rows: int = 32,
    n_samples: int = 48,
    baseline: int = 1000,
    pulse_height: int = 200,
    pulse_offset: int = 41,
    dt_between_ps: int = 10_000_000,
    noise: int = 3,
    seed: int = 0,
    pulses: Optional[Any] = None,
    channel_offset_ps: int = 0,
) -> str:
    """Write a synthetic VX2730 CSV run tree and return the run directory.

    Layout matches the adapter's expectations
    (reference: utils/formats/vx2730.py:117-134): files under
    ``{data_root}/{run_name}/RAW/Data_CH{c}_{i}.CSV``, ``;``-separated rows
    ``board;channel;timetag;_;_;_;_;sample0;sample1;...`` with two header
    lines on each channel's first file only. Every waveform carries a
    negative square pulse of ``pulse_height`` ADC at ``pulse_offset`` —
    placed after the VX2730 baseline window (samples 0-40) by default so
    computed baselines stay clean.

    ``pulses`` overrides the single default pulse with an explicit list of
    ``(offset, height, width)`` square pulses per waveform — use it to
    build multi-pulse events that discriminate peak-finding options
    (distance/prominence/width) and hit-merging gaps.

    ``channel_offset_ps`` staggers channel ``ch``'s timestamps by
    ``ch * channel_offset_ps`` — cross-channel gaps then discriminate the
    event-layer time windows (df_events / hit_grouped / df_paired).
    """
    import os

    rng = np.random.default_rng(seed)
    raw_dir = os.path.join(str(data_root), run_name, "RAW")
    os.makedirs(raw_dir, exist_ok=True)
    header = "HEADER LINE 1\nHEADER LINE 2\n"
    for ch in range(n_channels):
        for fi in range(n_files_per_channel):
            lines = []
            t0 = fi * n_rows * dt_between_ps
            for i in range(n_rows):
                samples = np.full(n_samples, baseline, dtype=np.int64)
                if noise:
                    samples += rng.integers(-noise, noise + 1, n_samples)
                if pulses is None:
                    samples[pulse_offset:pulse_offset + 5] -= pulse_height
                else:
                    for off, height, width in pulses:
                        samples[off:off + width] -= int(height)
                ts = t0 + i * dt_between_ps + ch * channel_offset_ps
                fields = [0, ch, ts, 0, 0, 0, 0]
                fields.extend(int(s) for s in samples)
                lines.append(";".join(str(f) for f in fields))
            path = os.path.join(raw_dir, f"Data_CH{ch}_{fi}.CSV")
            body = "\n".join(lines) + "\n"
            with open(path, "w") as fh:
                fh.write((header if fi == 0 else "") + body)
    return os.path.join(str(data_root), run_name)


_VX2730_HEADER = b"HEADER LINE 1\nHEADER LINE 2\n"


def _ascii_fields(values: np.ndarray, width: int, last: str) -> tuple:
    """Non-negative ints ``(n, F)`` as ASCII decimal fields: a uint8 cell
    array ``(n, F, width + 1)`` of right-aligned digits, each field followed
    by ``;`` (the row's last by ``last``), and the mask of its used bytes."""
    v = values.astype(np.int64)[..., None] // (10 ** np.arange(width - 1, -1, -1))
    if np.any(v[..., 0] >= 10):
        raise ValueError(f"a field has more than {width} digits")
    cells = np.empty(values.shape + (width + 1,), np.uint8)
    cells[..., :width] = (v % 10).astype(np.uint8) + ord("0")
    cells[..., width] = ord(";")
    cells[:, -1, width] = ord(last)
    used = np.ones(cells.shape, bool)
    used[..., :width] = v > 0
    used[..., width - 1] = True  # a zero field writes "0"
    return cells, used


# every uint16 sample value as its 5-digit field (digits, then ";"): the
# samples are formatted by one gather from these tables
_SAMPLE_CELLS, _SAMPLE_USED = (a[:, 0] for a in _ascii_fields(
    np.arange(1 << 16).reshape(-1, 1), 5, ";"))


def write_vx2730_run(
    data_root: str,
    run_name: str,
    waves: np.ndarray,
    timestamps: np.ndarray,
    channel: int,
    n_files: int = 1,
    board: int = 0,
    chunk_rows: int = 8192,
) -> list:
    """Write one channel of a VX2730 CSV run from arrays, vectorised.

    ``waves`` is ``(n, L)`` int samples in [0, 65535] and ``timestamps`` ``(n,)``
    non-negative int ps. Rows go in order into ``n_files`` files of equal
    size, ``{data_root}/{run_name}/RAW/Data_CH{channel}_{i}.CSV``, in the
    layout of :func:`make_synthetic_vx2730_run` (``;``-separated
    ``board;channel;timetag;0;0;0;0;samples...``, two header lines on the
    channel's first file only), byte for byte: the rows are formatted by
    numpy a block at a time, not by Python per value. Returns the paths.
    """
    import os

    waves = np.asarray(waves)
    timestamps = np.asarray(timestamps, np.int64)
    n = len(waves)
    if n % n_files or len(timestamps) != n:
        raise ValueError("rows must split evenly into n_files, one timestamp per row")
    if waves.min(initial=0) < 0 or waves.max(initial=0) >= 1 << 16 \
            or timestamps.min(initial=0) < 0:
        raise ValueError("samples must lie in [0, 65535] and timestamps be non-negative")
    raw_dir = os.path.join(str(data_root), run_name, "RAW")
    os.makedirs(raw_dir, exist_ok=True)
    per_file = n // n_files
    paths = []
    for fi in range(n_files):
        path = os.path.join(raw_dir, f"Data_CH{channel}_{fi}.CSV")
        with open(path, "wb") as fh:
            if fi == 0:
                fh.write(_VX2730_HEADER)
            for lo in range(fi * per_file, (fi + 1) * per_file, chunk_rows):
                hi = min(lo + chunk_rows, (fi + 1) * per_file)
                m = hi - lo
                head = np.zeros((m, 7), np.int64)
                head[:, 0], head[:, 1], head[:, 2] = board, channel, timestamps[lo:hi]
                samples = waves[lo:hi].astype(np.int64)
                cells = _SAMPLE_CELLS[samples]
                cells[:, -1, -1] = ord("\n")
                parts = [_ascii_fields(head[:, :2], 5, ";"),
                         _ascii_fields(head[:, 2:], 19, ";"),
                         (cells, _SAMPLE_USED[samples])]
                cells = np.concatenate([c.reshape(m, -1) for c, _ in parts], axis=1)
                used = np.concatenate([u.reshape(m, -1) for _, u in parts], axis=1)
                fh.write(cells[used].tobytes())
        paths.append(path)
    return paths


def write_v1725_run(
    data_root: str,
    run_name: str = "run_bin",
    n_events: int = 4,
    n_samples: int = 32,
    board: int = 0,
    waves: Optional[Dict[int, np.ndarray]] = None,
    timestamps: Optional[Dict[int, np.ndarray]] = None,
    baselines: Optional[Dict[int, Any]] = None,
    n_files: int = 1,
) -> str:
    """Write a V1725 (DAW_DEMO binary) run from arrays, vectorised.

    Each event holds the same channels: ``waves`` maps a channel to its
    ``(n_events, n_samples)`` int16 samples (``n_samples`` even),
    ``timestamps`` a channel to its ``(n_events,)`` 48-bit timestamps and
    ``baselines`` a channel to a 16-bit baseline (a scalar or one per
    event). The events go in order into ``n_files`` files of equal size,
    ``{data_root}/{run_name}/RAW/test_raw_b{board}_seg{i}.bin``: a 16-byte
    event header with the channel mask at bytes 4 and 11, then per channel,
    ascending, a 12-byte header (size in 32-bit words, timestamp, baseline)
    and the little-endian samples. Without ``waves`` it writes the run of
    ``tests/utils.py::write_v1725_run``, byte for byte: channel 0 at 900
    with a 150-count dip at samples 10-13, channel 1 at 1100 with a
    300-count dip at 12-17, both at timestamp 1000 + 500 i. The events are
    laid out by one structured numpy array, not by Python per event.
    Returns the run directory.
    """
    import os

    if waves is None:
        wave0 = np.full(n_samples, 900, dtype=np.int16)
        wave0[10:14] -= 150
        wave1 = np.full(n_samples, 1100, dtype=np.int16)
        wave1[12:18] -= 300
        waves = {0: np.tile(wave0, (n_events, 1)), 1: np.tile(wave1, (n_events, 1))}
        ts = 1000 + np.arange(n_events, dtype=np.int64) * 500
        timestamps = {0: ts, 1: ts}
        baselines = {0: 900, 1: 1100}
    timestamps, baselines = timestamps or {}, baselines or {}
    chans = sorted(waves)
    if n_samples % 2 or n_events % n_files:
        raise ValueError("n_samples must be even and events split evenly into n_files")
    mask = sum(1 << c for c in chans)
    layout = [("header", np.uint8, 16)] + [
        (f"c{c}_{part}", dt, k) for c in chans for part, dt, k in (
            ("size", np.uint8, 3), ("flags", np.uint8, ()), ("ts", "<u4", ()),
            ("ts_hi", "<u2", ()), ("baseline", "<u2", ()), ("wave", "<i2", n_samples))]
    events = np.zeros(n_events, dtype=np.dtype(layout))
    events["header"][:, 4] = mask & 0xFF
    events["header"][:, 11] = (mask >> 8) & 0xFF
    size_words = 3 + n_samples // 2
    for c in chans:
        events[f"c{c}_size"] = np.frombuffer(
            (size_words & ((1 << 22) - 1)).to_bytes(3, "little"), np.uint8)
        ts = np.broadcast_to(np.asarray(timestamps.get(c, 0), np.int64), (n_events,))
        events[f"c{c}_ts"] = ts & 0xFFFFFFFF
        events[f"c{c}_ts_hi"] = (ts >> 32) & 0xFFFF
        events[f"c{c}_baseline"] = np.asarray(baselines.get(c, 0), np.int64) & 0xFFFF
        events[f"c{c}_wave"] = np.asarray(waves[c], dtype=np.int16)
    raw = os.path.join(str(data_root), run_name, "RAW")
    os.makedirs(raw, exist_ok=True)
    per_file = n_events // n_files
    for i in range(n_files):
        with open(os.path.join(raw, f"test_raw_b{board}_seg{i}.bin"), "wb") as fh:
            fh.write(events[i * per_file:(i + 1) * per_file].tobytes())
    return os.path.join(str(data_root), run_name)


def make_tiny_context(
    tmp_dir: str,
    st_waveforms: Optional[Any] = None,
    run_id: str = "test_run",
    config: Optional[dict] = None,
    **fake_kwargs: Any,
):
    """A Context over ``tmp_dir`` with st_waveforms injected for ``run_id``."""
    from waveformanalysis_tpu_torch.context.context import Context

    cfg = {"show_progress": False}
    cfg.update(config or {})
    ctx = Context(storage_dir=str(tmp_dir), config=cfg)
    if st_waveforms is None:
        st_waveforms = make_fake_st_waveforms(**fake_kwargs)
    ctx.inject_data(run_id, "st_waveforms", st_waveforms)
    return ctx
