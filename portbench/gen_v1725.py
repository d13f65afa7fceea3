"""The V1725 DAW run of the benchmark: ragged self-triggered records in the
DAW_DEMO binary, made from a seed.

``daw_run`` draws one record a channel an interaction: S1 records on even
interactions, S2 records on odd ones, each at its own even length (S1
uniform on the format's ``s1_lengths``, S2 log-uniform on ``s2_lengths``,
rounded to an even count). Each record's samples are bench.py's
``make_batch`` arithmetic at the record's own length (a narrow S1, sigma 3
and 400 ADC, or a wide S2, sigma 25 and 250 ADC, centred in [60, L - 60),
noise sigma 2, on 1000 ADC, rounded), mirrored about the DC level into a
negative pulse: ``dc - (w - 1000)``. Channel c's record of interaction k
starts at sample ``k * interaction_ticks + (c mod 4) * offset_ticks``.
The draws run on the given device, in chunks of a fixed size, so a seed
gives the same run on one kind of device.

``write_daw_files`` writes records in that order as the CAEN V1725 DAW_DEMO
binary (the upstream's ``utils/formats/v1725.py``): a 16-byte event header
a interaction (event size in 32-bit words and the 0xA marker, the channel
mask in bytes 4 and 11, the event counter, the first record's time tag),
then a 12-byte header a channel, ascending (its size in 32-bit words with
the three header words, the truncation flag, the 48-bit sample-index
timestamp, the 16-bit baseline) and its little-endian int16 samples, two
to a word. The events go in order into ``n_files`` files
``{data_root}/{run}/RAW/daw_b{board}_seg{i}.bin``. Imports nothing of the
program.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

CHUNK = 16_384  # records drawn at a time (the draws depend on it: keep it fixed)


def _lengths(n: int, s1_event: torch.Tensor, fmt: dict, gen: torch.Generator) -> torch.Tensor:
    """(n,) even record lengths: S1 uniform, S2 log-uniform, each on its range."""
    dev = gen.device
    lo1, hi1 = (int(v) for v in fmt["s1_lengths"])
    lo2, hi2 = (int(v) for v in fmt["s2_lengths"])
    s1 = torch.randint(lo1 // 2, hi1 // 2 + 1, (n,), generator=gen, device=dev) * 2
    u = torch.rand((n,), generator=gen, device=dev, dtype=torch.float64)
    s2 = torch.exp(math.log(lo2) + u * (math.log(hi2) - math.log(lo2)))
    s2 = (torch.round(s2 / 2) * 2).to(torch.int64).clamp(lo2, hi2)
    return torch.where(s1_event, s1, s2)


def daw_run(fmt: dict, n_records: int, seed: int, device) -> dict:
    """The run's records in file order (interaction-major, channel
    ascending): ``channel`` int16, ``length`` int32, ``sample_index``
    int64, ``baseline`` int (one for every record) and ``pool``, every
    record's int16 samples in that order."""
    channels = int(fmt["channels"])
    if n_records % channels:
        raise ValueError(f"{n_records} records do not fill whole interactions of "
                         f"{channels} channels")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dev = gen.device
    n = n_records
    interaction = torch.arange(n, device=dev) // channels
    channel = torch.arange(n, device=dev) % channels
    s1_event = interaction % 2 == 0
    lengths = _lengths(n, s1_event, fmt, gen)
    span = (lengths - 120).to(torch.float32)
    centers = 60.0 + torch.floor(torch.rand((n,), generator=gen, device=dev) * span)
    sigma = torch.where(s1_event, 3.0, 25.0)
    amp = torch.where(s1_event, 400.0, 250.0)
    dc = int(fmt["dc_level"])
    parts = []
    for lo in range(0, n, CHUNK):
        L = lengths[lo:lo + CHUNK]
        m = int(L.sum())
        starts = torch.cumsum(L, 0) - L
        row = torch.repeat_interleave(torch.arange(len(L), device=dev), L)
        t = (torch.arange(m, device=dev) - starts[row]).to(torch.float32)
        c, s, a = centers[lo:lo + CHUNK][row], sigma[lo:lo + CHUNK][row], amp[lo:lo + CHUNK][row]
        w = torch.randn((m,), generator=gen, device=dev).mul_(2.0)
        w += 1000.0 + a * torch.exp(-((t - c) ** 2) / (2 * s ** 2))
        w = torch.round(w).to(torch.int32)
        parts.append((dc - (w - 1000)).to(torch.int16).cpu())
    ticks = (interaction * int(fmt["interaction_ticks"])
             + (channel % 4) * int(fmt["channel_offset_ticks"]))
    return {"channel": channel.to(torch.int16).cpu().numpy(),
            "length": lengths.to(torch.int32).cpu().numpy(),
            "sample_index": ticks.to(torch.int64).cpu().numpy(),
            "baseline": dc,
            "pool": torch.cat(parts).numpy() if parts else np.zeros(0, np.int16)}


def _record_headers(channel, length, sample_index, baseline) -> np.ndarray:
    """(n, 6) uint16 words of the 12-byte channel headers."""
    size = 3 + length.astype(np.int64) // 2
    ts = sample_index.astype(np.int64)
    h = np.zeros((len(channel), 6), np.uint16)
    h[:, 0] = size & 0xFFFF
    h[:, 1] = (size >> 16) & 0x3F  # bits 16-21 of the size; flags (byte 3) 0
    h[:, 2] = ts & 0xFFFF
    h[:, 3] = (ts >> 16) & 0xFFFF
    h[:, 4] = (ts >> 32) & 0xFFFF
    h[:, 5] = np.asarray(baseline, np.int64) & 0xFFFF
    return h


def write_daw_files(data_root: str, run: str, arrays: dict, channels: int, n_files: int,
                    board: int = 0) -> list:
    """Write ``daw_run``'s records, ``channels`` to an event, as ``n_files``
    DAW_DEMO files of whole events. Returns the paths."""
    channel = np.asarray(arrays["channel"], np.int64)
    length = np.asarray(arrays["length"], np.int64)
    ts = np.asarray(arrays["sample_index"], np.int64)
    pool = np.asarray(arrays["pool"], np.int16)
    n = len(channel)
    events = n // channels
    if n % channels or events % n_files or np.any(length % 2):
        raise ValueError("records must fill whole events split evenly into the files, "
                         "each of an even length")
    if not np.array_equal(channel.reshape(events, channels),
                          np.broadcast_to(np.arange(channels), (events, channels))):
        raise ValueError("each event must hold every channel once, ascending")
    offset = np.concatenate([[0], np.cumsum(length)[:-1]])
    headers = _record_headers(channel, length, ts, np.broadcast_to(arrays["baseline"], (n,)))
    mask = (1 << channels) - 1
    raw = os.path.join(str(data_root), run, "RAW")
    os.makedirs(raw, exist_ok=True)
    per_file = events // n_files
    paths = []
    for fi in range(n_files):
        e0, e1 = fi * per_file, (fi + 1) * per_file
        r0, r1 = e0 * channels, e1 * channels
        base = offset[r0]
        words = pool[base:base + int(length[r0:r1].sum())].view(np.uint16)
        first = np.arange(r0, r1, channels)
        ev_words = 4 + (3 * channels + length[r0:r1].reshape(-1, channels).sum(1) // 2)
        ev = np.zeros((per_file, 8), np.uint16)
        ev[:, 0] = ev_words & 0xFFFF
        ev[:, 1] = ((ev_words >> 16) & 0x0FFF) | 0xA000
        ev[:, 2] = mask & 0xFF
        count = np.arange(e0, e1, dtype=np.int64) & 0xFFFFFF
        ev[:, 4] = count & 0xFFFF
        ev[:, 5] = ((count >> 16) & 0xFF) | (((mask >> 8) & 0xFF) << 8)
        ev[:, 6] = ts[first] & 0xFFFF
        ev[:, 7] = (ts[first] >> 16) & 0xFFFF
        # each event header, then each record's header, before the record's
        # first sample (np.insert keeps the order of equal positions)
        at = offset[r0:r1] - base
        where = np.concatenate([np.repeat(at[::channels], 8).reshape(per_file, 8),
                                np.repeat(at, 6).reshape(per_file, channels * 6)], axis=1)
        values = np.concatenate([ev, headers[r0:r1].reshape(per_file, channels * 6)], axis=1)
        out = np.insert(words, where.reshape(-1), values.reshape(-1))
        path = os.path.join(raw, f"daw_b{board}_seg{fi}.bin")
        with open(path, "wb") as fh:
            fh.write(out.astype("<u2", copy=False).tobytes())
        paths.append(path)
    return paths
