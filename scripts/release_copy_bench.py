#!/usr/bin/env python3
"""Time ways to bring one filtered wave matrix from the card to the host.

    python3 scripts/release_copy_bench.py [--events 1048576] [--length 256]

When the outermost ``Context.get_data`` returns, the Context moves the
device columns it cached (route B's float32 filtered waves) to the host
(``Context._release_device_columns``). This script times, on one NVIDIA
GPU, each way of making that host copy of an ``(events, length)`` float32
matrix, every repetition into fresh host memory as the release makes it:

- ``cpu``: ``tensor.cpu()``, what ``Table.to_host`` does;
- ``numpy_dst``: a NumPy-allocated destination filled by ``copy_``;
- ``pinned``: a page-locked destination filled by a non-blocking copy;
- ``touch``: only allocating and writing the host buffer (no device copy),
  the host's share of the cost.

It prints the card, the host's transparent-huge-page mode and the median
of 5 host-clock timings per way, each ending with the data on the host.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch


def median_s(fn, reps: int = 5) -> float:
    fn()  # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--events", type=int, default=1_048_576)
    ap.add_argument("--length", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    thp = Path("/sys/kernel/mm/transparent_hugepage/enabled")
    mode = thp.read_text().strip() if thp.exists() else "unknown"
    shape = (args.events, args.length)
    x = torch.randn(shape, device="cuda")
    gb = x.numel() * 4 / 1e9

    def cpu():
        return x.cpu().numpy()

    def numpy_dst():
        dst = np.empty(shape, np.float32)
        torch.from_numpy(dst).copy_(x)
        return dst

    def pinned():
        dst = torch.empty(shape, dtype=torch.float32, pin_memory=True)
        dst.copy_(x, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return dst.numpy()

    def touch():
        dst = np.empty(shape, np.float32)
        dst.fill(1.0)
        return dst

    out = {name: median_s(fn) for name, fn in
           (("cpu", cpu), ("numpy_dst", numpy_dst), ("pinned", pinned), ("touch", touch))}
    print(f"release copy of a {shape[0]}x{shape[1]} float32 matrix ({gb:.3f} GB) on {smi}; "
          f"transparent huge pages: {mode}; median of 5, ms: "
          + ", ".join(f"{k} {v * 1e3:.1f} ({gb / v:.2f} GB/s)" for k, v in out.items()),
          flush=True)


if __name__ == "__main__":
    main()
