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
VX2730 reader (see csv_decode.cpp for the rationale and the C ABI). The
library's typed VX2730 and V1725 entries serve the records build and the
V1725 device unpack; their bindings come with those (ROADMAP.md Queue 1,
item 4).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

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
