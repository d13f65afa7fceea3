"""Native (C++) helpers for host-side hot paths.

Port of ``waveformanalysis_tpu/native/``. The device path is PyTorch and
CUDA; the host runtime around it (DAQ decode) uses a small C++ component
where Python-side conversion dominated profiles. It is compiled with the
system g++ at first use, never at import, into ``<checkout>/build/native``
(never into the package directory), and loaded via ctypes. Callers degrade
gracefully when the toolchain is unavailable.

The library's file name carries a hash of the source, the flags and the
host CPU's instruction-set flags (the build uses ``-march=native``), so an
edited source or another CPU builds anew and an unchanged one is reused.

Currently: ``csv_decode`` -- one-pass delimited-numeric decoder used by the
VX2730 reader (see csv_decode.cpp for the rationale and the C ABI), its
typed single-pass VX2730 entry (the records build's parts), and the V1725
binary decoder and header-only walk (the records build from V1725 files
and the V1725 device unpack, ``ops/v1725_device.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "csv_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# -march=native: the SWAR digit kernels and memchr scans benefit from
# BMI2/AVX codegen; the plain -O3 build is the fallback for a compiler
# that rejects the flag
_FLAG_SETS = (
    ("-O3", "-march=native", "-shared", "-fPIC"),
    ("-O3", "-shared", "-fPIC"),
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None
_load_failed = False


def _cpu_flags() -> bytes:
    """The host CPU's instruction-set flags (Linux), b"" elsewhere."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            for line in fh:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def library_path() -> Path:
    """Where the library for this source, these flags and this CPU lives."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(repr(_FLAG_SETS).encode() + _cpu_flags())
    return BUILD_DIR / f"libwfa_native_{digest.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> bool:
    """Compile the shared library unless it exists. Returns success."""
    try:
        if lib_path.exists():
            return True
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # per-process temp name: concurrent builders must not share a tmp
        # file (interleaved g++ output would install a corrupt .so); the
        # final rename is atomic, so whichever finishes last wins cleanly
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        for flags in _FLAG_SETS:
            proc = subprocess.run(["g++", *flags, str(_SRC), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=120)
            if proc.returncode == 0:
                break
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            logger.warning("native build failed: %s", proc.stderr[-500:])
            return False
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError) as err:  # no g++, read-only dir
        logger.warning("native build unavailable: %s", err)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if the
    toolchain or build is unavailable (callers fall back to Python paths)."""
    global _lib, _lib_path, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = library_path()
        if not _build(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.wfa_csv_shape.restype = ctypes.c_longlong
            lib.wfa_csv_shape.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_char, ctypes.POINTER(ctypes.c_longlong),
            ]
            lib.wfa_csv_decode.restype = ctypes.c_longlong
            lib.wfa_csv_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_char, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.wfa_csv_decode_typed.restype = ctypes.c_longlong
            lib.wfa_csv_decode_typed.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_char, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_uint16),
            ]
            lib.wfa_v1725_scan.restype = ctypes.c_longlong
            lib.wfa_v1725_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_longlong),
            ]
            v1725_columns = [
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.wfa_v1725_decode.restype = ctypes.c_longlong
            lib.wfa_v1725_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong, *v1725_columns,
                ctypes.POINTER(ctypes.c_uint16),
            ]
            lib.wfa_v1725_headers.restype = ctypes.c_longlong
            lib.wfa_v1725_headers.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong, *v1725_columns,
            ]
            _lib, _lib_path = lib, path
        except (OSError, AttributeError) as err:
            logger.warning("native load failed: %s", err)
            _load_failed = True
    return _lib


def loaded_path() -> Optional[Path]:
    """Path of the loaded library, None before a successful get_lib()."""
    return _lib_path


def decode_csv_bytes(data: bytes, skip_rows: int = 0,
                     delimiter: str = ";") -> Optional[np.ndarray]:
    """Decode delimited numeric text to a row-major float64 matrix.

    Rows whose field count differs from the first data row are skipped; a
    trailing delimiter does not open a field. Returns None when the native
    library is unavailable (caller falls back) or the file has no data.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    if n == 0:
        return np.zeros((0, 0), dtype=np.float64)
    ncols = ctypes.c_longlong(0)
    delim = delimiter.encode()[:1]
    rows = lib.wfa_csv_shape(data, n, skip_rows, delim,
                             ctypes.byref(ncols))
    if rows <= 0 or ncols.value <= 0:
        return np.zeros((0, 0), dtype=np.float64)
    out = np.empty((rows, ncols.value), dtype=np.float64)
    got = lib.wfa_csv_decode(
        data, n, skip_rows, delim, ncols.value, rows,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out[:got]


def decode_csv_vx2730_typed(
    data: bytes,
    skip_rows: int = 0,
    delimiter: str = ";",
    samples_start: int = 7,
    baseline_start: int = 7,
    baseline_end: int = 47,
) -> Optional[dict]:
    """Typed single-pass VX2730 decode (see wfa_csv_decode_typed).

    Returns {board i16, channel i16, timestamp i64, baseline f8,
    samples u16 (n, L)} or None when the native library is unavailable OR
    the file contains anomalies the strict typed parser rejects -- the
    caller then falls back to :func:`decode_csv_bytes` + the generic part
    builder, preserving bit-parity on weird inputs.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    if n == 0:
        return {"board": np.zeros(0, np.int16), "channel": np.zeros(0, np.int16),
                "timestamp": np.zeros(0, np.int64),
                "baseline": np.zeros(0, np.float64),
                "samples": np.zeros((0, 0), np.uint16)}
    ncols = ctypes.c_longlong(0)
    delim = delimiter.encode()[:1]
    rows = lib.wfa_csv_shape(data, n, skip_rows, delim, ctypes.byref(ncols))
    if rows <= 0 or ncols.value <= samples_start:
        return None  # unusual shape: let the generic path handle it
    n_samples = ncols.value - samples_start
    board = np.empty(rows, dtype=np.int16)
    channel = np.empty(rows, dtype=np.int16)
    timestamp = np.empty(rows, dtype=np.int64)
    baseline = np.empty(rows, dtype=np.float64)
    samples = np.empty((rows, n_samples), dtype=np.uint16)
    got = lib.wfa_csv_decode_typed(
        data, n, skip_rows, delim, ncols.value, rows,
        samples_start, baseline_start, baseline_end,
        _ptr(board, ctypes.c_int16), _ptr(channel, ctypes.c_int16),
        _ptr(timestamp, ctypes.c_longlong), _ptr(baseline, ctypes.c_double),
        _ptr(samples, ctypes.c_uint16),
    )
    if got < 0:
        return None  # anomaly: strict parser rejected, use the generic path
    return {
        "board": board[:got], "channel": channel[:got],
        "timestamp": timestamp[:got], "baseline": baseline[:got],
        "samples": samples[:got],
    }


def _ptr(arr: np.ndarray, ctype: Any) -> Any:
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _v1725_columns(records: int) -> dict:
    return {
        "channel": np.empty(records, dtype=np.int16),
        "timestamp": np.empty(records, dtype=np.int64),
        "baseline": np.empty(records, dtype=np.float64),
        "trunc": np.empty(records, dtype=np.uint8),
        "offset": np.empty(records, dtype=np.int64),
        "n_samples": np.empty(records, dtype=np.int32),
    }


def _v1725_pointers(cols: dict) -> tuple:
    return (_ptr(cols["channel"], ctypes.c_int16), _ptr(cols["timestamp"], ctypes.c_longlong),
            _ptr(cols["baseline"], ctypes.c_double), _ptr(cols["trunc"], ctypes.c_uint8),
            _ptr(cols["offset"], ctypes.c_longlong), _ptr(cols["n_samples"], ctypes.c_int32))


def scan_v1725_headers_bytes(data: bytes) -> Optional[dict]:
    """Header-only V1725 walk: per-record metadata + sample BYTE offsets.

    No samples are copied -- the device-unpack path uploads ``data`` once
    and gathers on the device (ops/v1725_device.py). Same truncation
    semantics as the full decoder; None when the library is unavailable.
    Keys: channel i16, timestamp i64, baseline f8, trunc u8, offset i64,
    n_samples i32.
    """
    lib = get_lib()
    if lib is None:
        return None
    total_samples = ctypes.c_longlong(0)
    records = lib.wfa_v1725_scan(data, len(data), ctypes.byref(total_samples))
    cols = _v1725_columns(records)
    if records:
        got = lib.wfa_v1725_headers(data, len(data), *_v1725_pointers(cols))
        assert got == records, (got, records)
    return cols


def decode_v1725_bytes(data: bytes) -> Optional[dict]:
    """Decode one V1725 DAW_DEMO binary buffer to columnar arrays.

    Returns {channel i16, timestamp i64, baseline f8, trunc u8,
    wave_offset i64, event_length i32, wave_pool u16} or None when the
    native library is unavailable. Bit-identical to the Python reader
    (formats/v1725.py), including stop-at-malformed-tail behavior.
    """
    lib = get_lib()
    if lib is None:
        return None
    total_samples = ctypes.c_longlong(0)
    records = lib.wfa_v1725_scan(data, len(data), ctypes.byref(total_samples))
    cols = _v1725_columns(records)
    pool = np.empty(total_samples.value, dtype=np.uint16)
    if records:
        got = lib.wfa_v1725_decode(data, len(data), *_v1725_pointers(cols),
                                   _ptr(pool, ctypes.c_uint16))
        assert got == records, (got, records)
    cols["wave_offset"] = cols.pop("offset")
    cols["event_length"] = cols.pop("n_samples")
    cols["wave_pool"] = pool
    return cols
