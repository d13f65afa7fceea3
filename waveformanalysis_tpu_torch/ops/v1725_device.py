"""On-device V1725 sample unpacking: raw file bytes -> padded wave matrix.

Port of ``waveformanalysis_tpu/ops/v1725_device.py``. The host's role
shrinks to a header-only walk (byte offsets + per-record metadata; no
sample copying); the raw buffer uploads once and a torch gather builds the
(n, L) int16 wave matrix on the device, where the feature and peak kernels
consume it. The host walker (formats/v1725.py) remains the default and the
parity oracle (tests/test_torch_v1725_device.py).

Sample offsets are always even (the headers are 4-byte structures), so the
samples are the buffer read as little-endian int16, and record i's sample
k sits at int16 index ``offset_i // 2 + k``: the buffer uploads as an int16
tensor and each record is one row of its length-L sliding window. The JAX
package's uint32 word gather and bit slice are not needed, and torch's
unsigned types, which support few operations on CUDA, never appear.

Event layout (reference: utils/formats/v1725.py:26-115): 16-byte event
header (channel mask at bytes 4 and 11), then per active channel a 12-byte
channel header (22-bit size in words, trunc flag bit 6 of byte 3, 48-bit
timestamp, 16-bit baseline) followed by little-endian int16 samples.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

EVENT_HEADER_BYTES = 16
CH_HEADER_BYTES = 12


def scan_headers(
    buf: bytes, board: int, base_offset: int = 0
) -> Dict[str, np.ndarray]:
    """Header-only walk: per-record metadata + sample byte offsets.

    Uses the native walker when available (wfa_v1725_headers), with the
    pure python loop as the exact-parity fallback. Same truncation
    semantics as the full walker (short header/waveform -> stop this file
    with a warning); ``base_offset`` shifts offsets when several files
    concatenate into one device buffer.
    """
    from waveformanalysis_tpu_torch.native import scan_v1725_headers_bytes

    native = scan_v1725_headers_bytes(buf)
    if native is None:
        return _scan_headers_py(buf, board, base_offset)
    n_rec = len(native["offset"])
    return {
        "board": np.full(n_rec, board, dtype=np.int16),
        "channel": native["channel"],
        "timestamp": native["timestamp"],
        "baseline": native["baseline"],
        "trunc": native["trunc"].astype(bool),
        "offset": native["offset"] + base_offset,
        "n_samples": native["n_samples"],
    }


def _scan_headers_py(
    buf: bytes, board: int, base_offset: int = 0
) -> Dict[str, np.ndarray]:
    """Pure-python header walk (parity oracle for the native scan)."""
    n = len(buf)
    view = memoryview(buf)
    boards: List[int] = []
    channels: List[int] = []
    timestamps: List[int] = []
    baselines: List[int] = []
    truncs: List[bool] = []
    offsets: List[int] = []
    lengths: List[int] = []
    pos = 0
    while pos + EVENT_HEADER_BYTES <= n:
        header = view[pos : pos + EVENT_HEADER_BYTES]
        pos += EVENT_HEADER_BYTES
        mask = header[4] | (header[11] << 8)
        truncated = False
        for ch in range(16):
            if not (mask >> ch) & 1:
                continue
            if pos + CH_HEADER_BYTES > n:
                logger.warning("Short channel header at byte %d", pos)
                truncated = True
                break
            ch_header = view[pos : pos + CH_HEADER_BYTES]
            pos += CH_HEADER_BYTES
            size_words = (
                int.from_bytes(ch_header[0:3], "little") & ((1 << 22) - 1)
            )
            sig_bytes = (size_words - 3) * 4
            if sig_bytes < 0 or pos + sig_bytes > n:
                logger.warning("Short waveform at byte %d", pos)
                truncated = True
                break
            boards.append(board)
            channels.append(ch)
            timestamps.append(int.from_bytes(ch_header[4:10], "little"))
            baselines.append(int.from_bytes(ch_header[10:12], "little"))
            truncs.append(bool((ch_header[3] >> 6) & 1))
            offsets.append(base_offset + pos)
            lengths.append(sig_bytes // 2)
            pos += sig_bytes
        if truncated:
            break
    return {
        "board": np.asarray(boards, dtype=np.int16),
        "channel": np.asarray(channels, dtype=np.int16),
        "timestamp": np.asarray(timestamps, dtype=np.int64),
        "baseline": np.asarray(baselines, dtype=np.float64),
        "trunc": np.asarray(truncs, dtype=bool),
        "offset": np.asarray(offsets, dtype=np.int64),
        "n_samples": np.asarray(lengths, dtype=np.int32),
    }


def unpack_samples_device(
    raw: Any, offsets: np.ndarray, lengths: np.ndarray, L: int, device: Any = "cuda"
) -> torch.Tensor:
    """(n, L) int16 wave matrix on ``device`` from a raw byte buffer.

    ``raw`` is the file bytes (bytes or uint8 array); offsets are byte
    positions of each record's first sample (always even); rows pad with
    zeros past ``lengths`` and truncate beyond ``L``. The buffer is copied
    once into a writable int16 array with L samples of zero padding (so
    every record's L-sample window lies inside it) and uploads once; int64
    indices leave no bound on its size. ``device="cuda"`` without a GPU
    raises.
    """
    dev = resolve_device(device)
    raw = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) \
        else np.asarray(raw, dtype=np.uint8)
    offsets = np.asarray(offsets, dtype=np.int64)
    if np.any(offsets % 2):
        raise ValueError("V1725 sample offsets must be even")
    L = int(L)
    n_words = (len(raw) + 1) // 2 + L
    buf = np.zeros(2 * n_words, dtype=np.uint8)
    buf[: len(raw)] = raw
    words = torch.from_numpy(buf.view("<i2")).to(dev)
    n = len(offsets)
    if n == 0:
        return torch.zeros((0, L), dtype=torch.int16, device=dev)
    starts = torch.from_numpy(offsets // 2).to(dev)
    valid = torch.from_numpy(np.minimum(np.asarray(lengths, np.int64), L)).to(dev)
    out = words.unfold(0, L, 1)[starts] if L else words.new_zeros((n, 0))
    col = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    return torch.where(col < valid[:, None], out, torch.zeros((), dtype=torch.int16,
                                                              device=dev))


def read_files_device(
    file_paths: List, wave_length: Optional[int] = None,
    board_from_path=None, _group_limit: Optional[int] = None,
    device: Any = "cuda",
) -> Tuple[Optional[torch.Tensor], Dict[str, np.ndarray]]:
    """(device wave matrix, metadata columns) for a list of V1725 files.

    File buffers concatenate (each padded to a 4-byte boundary) in GROUPS
    of at most about 2 GiB (``_group_limit`` bytes, which tests lower to
    exercise several groups); each group uploads once and the per-group
    matrices concatenate on ``device``. Metadata comes from the
    header-only host walk; ``offset`` values in the returned metadata are
    positions in the GLOBAL padded byte stream across all files.
    """
    # scan everything first: L depends on the longest record, and the
    # returned offsets are global
    bufs: List[bytes] = []
    metas: List[Dict[str, np.ndarray]] = []
    for fp in file_paths:
        path = Path(fp)
        if not path.exists():
            logger.warning("File not found: %s", path)
            continue
        board = board_from_path(path) if board_from_path else 0
        buf = path.read_bytes()
        metas.append(scan_headers(buf, board))
        pad = (-len(buf)) % 4
        if pad:
            buf = buf + b"\x00" * pad
        bufs.append(buf)

    if not metas or sum(len(m["offset"]) for m in metas) == 0:
        empty = {k: np.zeros(0, dtype=v.dtype) for k, v in
                 _scan_headers_py(b"", 0).items()}
        return None, empty

    max_samples = max(
        (int(m["n_samples"].max()) for m in metas if len(m["n_samples"])),
        default=1,
    )
    L = int(wave_length) if wave_length else max_samples
    group_limit = _group_limit if _group_limit is not None else 2**31

    global_meta: List[Dict[str, np.ndarray]] = []
    parts: List[torch.Tensor] = []
    g_bufs: List[bytes] = []
    g_offsets: List[np.ndarray] = []
    g_lengths: List[np.ndarray] = []
    g_size = 0
    global_base = 0

    def _flush_group():
        nonlocal g_bufs, g_offsets, g_lengths, g_size
        if g_bufs and sum(len(o) for o in g_offsets):
            parts.append(unpack_samples_device(
                b"".join(g_bufs), np.concatenate(g_offsets),
                np.concatenate(g_lengths), L, device=device,
            ))
        g_bufs, g_offsets, g_lengths, g_size = [], [], [], 0

    for buf, m in zip(bufs, metas):
        if g_bufs and g_size + len(buf) > group_limit:
            _flush_group()
        g_bufs.append(buf)
        g_offsets.append(m["offset"] + g_size)
        g_lengths.append(m["n_samples"])
        g_size += len(buf)
        gm = dict(m)
        gm["offset"] = m["offset"] + global_base
        global_meta.append(gm)
        global_base += len(buf)
    _flush_group()

    meta = {
        k: np.concatenate([m[k] for m in global_meta])
        for k in global_meta[0]
    }
    if len(parts) == 1:
        return parts[0], meta
    return torch.cat(parts, dim=0), meta
