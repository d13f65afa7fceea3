#!/usr/bin/env python
"""Performance regression harness of the port: per-target wall time and
peak memory on a synthetic VX2730 run, compared with a baseline.

The twin of scripts/performance_regression_check.py. It writes a small
VX2730 run with the port's ``testing/fixtures.write_vx2730_run`` (negative
pulses on a 1000 ADC baseline, from a seed), then for each target runs a
fresh Context of the ``cuda`` profile over it ``--reps`` times and records
the mean and largest wall time of ``get_data`` and the host peak that
tracemalloc sees. On the card it also records the peak device memory above
the start of each call (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``).

    python scripts/performance_regression_check_torch.py [--targets a,b] [--reps 3]
    python scripts/performance_regression_check_torch.py --device cpu --save-baseline b.json
    python scripts/performance_regression_check_torch.py --baseline b.json [--tolerance 1.5]

Baselines are read from and written to only the paths given. Exit 1 when a
target's mean time exceeds its baseline times the tolerance, else 0.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
import tracemalloc
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DEFAULT_TARGETS = ["st_waveforms", "records", "basic_features", "df_events"]
DT_PS = 10_000_000  # between a channel's rows
OFFSET_PS = 20_000  # channel c's rows are c * OFFSET_PS later


def write_run(data_root: str, run: str, n_channels: int, n_rows: int, n_samples: int,
              n_files: int = 1, seed: int = 0) -> None:
    """``n_rows`` waveforms a channel in ``n_files`` files: a negative square
    pulse of 150-250 ADC and 4-16 samples after the baseline window, noise
    of +-3 ADC."""
    from waveformanalysis_tpu_torch.testing.fixtures import write_vx2730_run

    rng = np.random.default_rng(seed)
    ts = np.arange(n_rows, dtype=np.int64) * DT_PS
    for ch in range(n_channels):
        waves = 1000 + rng.integers(-3, 4, (n_rows, n_samples))
        at = rng.integers(41, max(n_samples - 16, 42), n_rows)
        width = rng.integers(4, 17, n_rows)
        height = rng.integers(150, 251, n_rows)
        cols = np.arange(n_samples)[None, :]
        pulse = (cols >= at[:, None]) & (cols < (at + width)[:, None])
        waves = np.where(pulse, waves - height[:, None], waves)
        write_vx2730_run(data_root, run, waves, ts + ch * OFFSET_PS, ch, n_files=n_files)


def measure(targets, device="cuda", n_channels=2, n_rows=12, n_samples=128, reps=3):
    import torch

    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.device import resolve_device
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile

    dev = resolve_device(device)
    results = {}
    with tempfile.TemporaryDirectory(prefix="wfa_perf_") as tmp:
        write_run(tmp, "perf", n_channels, n_rows, n_samples)
        for target in targets:
            times, peaks, dev_peaks = [], [], []
            for rep in range(reps):
                ctx = Context(
                    storage_dir=str(Path(tmp) / f"storage_{target}_{rep}"),
                    config={"show_progress": False, "data_root": tmp,
                            "daq_adapter": "vx2730", "device": str(dev)},
                )
                ctx.register(*get_profile("cuda"))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                    start = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                tracemalloc.start()
                t0 = time.perf_counter()
                ctx.get_data("perf", target)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
                _, peak = tracemalloc.get_traced_memory()
                tracemalloc.stop()
                if dev.type == "cuda":
                    dev_peaks.append((torch.cuda.max_memory_allocated(dev) - start) / 1e6)
                ctx.close()
                times.append(dt)
                peaks.append(peak / 1e6)
            results[target] = {
                "avg_s": round(statistics.mean(times), 4),
                "max_s": round(max(times), 4),
                "peak_mb": round(max(peaks), 2),
            }
            if dev_peaks:
                results[target]["device_peak_mb"] = round(max(dev_peaks), 2)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--targets", default=",".join(DEFAULT_TARGETS))
    p.add_argument("--device", default="cuda", help="torch device of the Contexts")
    p.add_argument("--baseline", default=None, help="Baseline JSON to compare against")
    p.add_argument("--save-baseline", default=None,
                   help="Write results as a new baseline JSON")
    p.add_argument("--tolerance", type=float, default=1.5,
                   help="Fail when avg time exceeds baseline x tolerance")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)

    results = measure(args.targets.split(","), args.device, reps=args.reps)
    for target, r in results.items():
        card = (f" device peak={r['device_peak_mb']:.2f}MB"
                if "device_peak_mb" in r else "")
        print(f"{target:<24} avg={r['avg_s']:.4f}s max={r['max_s']:.4f}s "
              f"peak={r['peak_mb']:.2f}MB{card}")

    if args.save_baseline:
        with open(args.save_baseline, "w") as fh:
            json.dump(results, fh, indent=2)
        print(f"baseline saved to {args.save_baseline}")

    if args.baseline:
        with open(args.baseline) as fh:
            baseline = json.load(fh)
        failed = []
        for target, r in results.items():
            base = baseline.get(target)
            if not base:
                continue
            if r["avg_s"] > base["avg_s"] * args.tolerance:
                failed.append(
                    f"{target}: {r['avg_s']:.4f}s > {base['avg_s']:.4f}s x {args.tolerance}"
                )
        if failed:
            print("REGRESSIONS:")
            for line in failed:
                print(" ", line)
            return 1
        print("no regressions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
