"""Build a CUDA source under ``csrc/`` with nvcc and load it with ctypes.

A kernel source is compiled at its first use, never at import, into a
shared library with a plain C interface under ``<checkout>/build/kernels``.
The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source, header or flag set
builds anew and an unchanged one is reused. ``ptxas -v`` output (registers,
spills) goes to a log beside the library. ``build_all`` compiles several
sources at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# --fmad=false and no fast-math: exact outputs depend on f32 comparisons of
# interpolated values, so products must not contract into adds
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of the kernel launches a
    wrapper made: under a lock, since several threads (a thread pool of
    Contexts) launch through one wrapper."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


@dataclass
class Built:
    """A loaded kernel library and what its build reported."""

    lib: ctypes.CDLL
    path: Path
    log: Path
    seconds: float  # 0.0 when an earlier build was reused
    ptxas: List[Dict[str, object]] = field(default_factory=list)


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
        "/usr/local/cuda/bin): the CUDA kernels are built from "
        "waveformanalysis_tpu_torch/csrc with nvcc at first use"
    )


def parse_ptxas(log: str) -> List[Dict[str, object]]:
    """Per-function registers and spill bytes from ``ptxas -v`` output."""
    out: List[Dict[str, object]] = []
    cur: Dict[str, object] = {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and cur:
            cur["static_smem"] = int(m.group(1))
    return out


@functools.lru_cache(maxsize=None)
def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` (once per source hash) and load it."""
    src = CSRC_DIR / f"{name}.cu"
    nvcc = find_nvcc()
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    key = digest.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{name}_{key}.so"
    log = BUILD_DIR / f"{name}_{key}.log"
    seconds = 0.0
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    return Built(lib=lib, path=so, log=log, seconds=seconds,
                 ptxas=parse_ptxas(log.read_text()) if log.exists() else [])


def build_all(names: Sequence[str]) -> Dict[str, Built]:
    """Build several sources concurrently (one nvcc each); name -> Built."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))
