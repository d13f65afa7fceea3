"""The benchmark's input generators, frozen here.

``make_batch`` is bench.py's ``make_batch`` (positive pulses on a 1000 ADC
baseline: a narrow S1, sigma 3 and 400 ADC, on even rows and a wide S2,
sigma 25 and 250 ADC, on odd rows, centres drawn in [60, L - 60), noise
sigma 2, rounded to int16), rewritten in torch so that it runs on the card
from a ``torch.Generator`` in a few large calls. ``write_vx2730_run`` is the
port's ``testing.fixtures.write_vx2730_run`` (the upstream VX2730 CSV
layout: ``;``-separated, two header lines, ps timestamps) and ``vx2730_run``
is chip_smoke.py's ``write_ingest_run`` on top of it.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch


def make_batch(n: int, L: int, gen: torch.Generator) -> torch.Tensor:
    """(n, L) int16 waves on ``gen``'s device, drawn from ``gen``."""
    dev = gen.device
    t = torch.arange(L, device=dev, dtype=torch.float32)
    centers = torch.randint(60, L - 60, (n,), generator=gen, device=dev).to(torch.float32)
    even = torch.arange(n, device=dev) % 2 == 0
    sigma = torch.where(even, 3.0, 25.0)
    amp = torch.where(even, 400.0, 250.0)
    waves = torch.randn((n, L), generator=gen, device=dev).mul_(2.0)
    waves += 1000.0 + amp[:, None] * torch.exp(
        -((t[None, :] - centers[:, None]) ** 2) / (2 * sigma[:, None] ** 2))
    return torch.round(waves).to(torch.int16)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


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
    used[..., width - 1] = True  # a zero still prints one digit
    return cells, used


def write_vx2730_run(data_root: str, run_name: str, waves: np.ndarray,
                     timestamps: np.ndarray, channel: int, n_files: int = 1,
                     board: int = 0, chunk_rows: int = 8192) -> list:
    """One channel of a VX2730 CSV run: ``waves`` ``(n, L)`` in [0, 65535]
    and ``timestamps`` ``(n,)`` ps, in order into ``n_files`` files
    ``{data_root}/{run_name}/RAW/Data_CH{channel}_{i}.CSV`` of
    ``board;channel;timetag;0;0;0;0;samples...`` rows, the two header lines
    on the channel's first file only. Returns the paths."""
    waves = np.asarray(waves)
    timestamps = np.asarray(timestamps, np.int64)
    n = len(waves)
    if n % n_files or len(timestamps) != n:
        raise ValueError("rows must split evenly into n_files, one timestamp per row")
    if waves.min(initial=0) < 0 or waves.max(initial=0) >= 1 << 16 \
            or timestamps.min(initial=0) < 0:
        raise ValueError("samples must lie in [0, 65535] and timestamps be non-negative")
    sample_cells, sample_used = (a[:, 0] for a in _ascii_fields(
        np.arange(1 << 16).reshape(-1, 1), 5, ";"))
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
                cells = sample_cells[samples]
                cells[:, -1, -1] = ord("\n")
                parts = [_ascii_fields(head[:, :2], 5, ";"),
                         _ascii_fields(head[:, 2:], 19, ";"),
                         (cells, sample_used[samples])]
                cells = np.concatenate([c.reshape(m, -1) for c, _ in parts], axis=1)
                used = np.concatenate([u.reshape(m, -1) for _, u in parts], axis=1)
                fh.write(cells[used].tobytes())
        paths.append(path)
    return paths


def vx2730_arrays(waves: np.ndarray, dt_ps: int, offset_ps: int) -> dict:
    """The arrays of a two-channel run of ``waves``, in st_waveforms' row
    order: the first half of the rows is channel 0, the second channel 1;
    channel c's row i is at ``i * dt_ps + c * offset_ps``."""
    half = len(waves) // 2
    ts = np.arange(half, dtype=np.int64) * dt_ps
    return {"wave": waves, "timestamp": np.concatenate([ts, ts + offset_ps]),
            "channel": np.repeat(np.arange(2, dtype=np.int16), half)}


def vx2730_run(data_root: str, run: str, waves: np.ndarray, files: int, dt_ps: int,
               offset_ps: int) -> dict:
    """Write ``waves`` as a two-channel VX2730 run of ``files`` files a
    channel (see ``vx2730_arrays``) and return its arrays."""
    arrays = vx2730_arrays(waves, dt_ps, offset_ps)
    half = len(waves) // 2
    for ch in (0, 1):
        rows = slice(ch * half, (ch + 1) * half)
        write_vx2730_run(data_root, run, waves[rows], arrays["timestamp"][rows], ch,
                         n_files=files)
    return arrays


def link_run(data_root: str, source: str, run: str) -> str:
    """A fresh run name whose directory is ``source``'s (a symlink)."""
    Path(data_root, run).symlink_to(Path(data_root, source), target_is_directory=True)
    return run
