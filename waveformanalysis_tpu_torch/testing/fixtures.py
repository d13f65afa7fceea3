"""Public testing fixtures for downstream plugin authors.

Behavioral analog of the reference public fixture module
(reference: waveform_analysis/testing/fixtures.py:19-57):
``make_fake_st_waveforms`` builds synthetic structured waveforms with known
pulses; ``make_tiny_context`` returns a Context with those waveforms injected
so feature plugins can be unit-tested without DAQ decode.
"""

from __future__ import annotations

from typing import Any, Optional

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
