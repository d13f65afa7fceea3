#!/usr/bin/env python
"""CSV-parse benchmark of the port: waveform-load wall time by parse engine
and job count.

The twin of scripts/benchmark_io.py. It writes a synthetic VX2730 run as
scripts/performance_regression_check_torch.py does (the port's
``testing/fixtures.write_vx2730_run``) and times the port's
``utils/io.py::parse_and_stack_files`` on it for each engine and job count
(the best of ``--reps``). It does host work only: reading and parsing files
touches no device.

    python scripts/benchmark_io_torch.py [--n-files 50] [--engines auto,native] [--jobs 1,4,16]

Prints one line per engine and job count, then one JSON object with every
result.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-files", type=int, default=50)
    p.add_argument("--n-channels", type=int, default=2)
    p.add_argument("--n-rows", type=int, default=200)
    p.add_argument("--n-samples", type=int, default=200)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--engines", default="auto,native,pyarrow,pandas,numpy")
    p.add_argument("--jobs", default="1,4,16")
    args = p.parse_args(argv)

    from performance_regression_check_torch import write_run
    from waveformanalysis_tpu_torch.formats.adapter import get_adapter
    from waveformanalysis_tpu_torch.utils.io import parse_and_stack_files

    results = []
    with tempfile.TemporaryDirectory(prefix="wfa_bench_io_") as tmp:
        per_channel = max(args.n_files // args.n_channels, 1)
        write_run(tmp, "bench", args.n_channels, per_channel * args.n_rows, args.n_samples,
                  n_files=per_channel)
        groups = get_adapter("vx2730").scan_run(tmp, "bench")
        raw_files = [groups[ch] for ch in sorted(groups)]
        total_rows = sum(len(f) for f in raw_files) * args.n_rows

        for engine in args.engines.split(","):
            for n_jobs in (int(j) for j in args.jobs.split(",")):
                times = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    try:
                        parse_and_stack_files(raw_files, n_jobs=n_jobs, parse_engine=engine)
                    except Exception as e:
                        print(f"engine={engine} failed: {e}", file=sys.stderr)
                        times = None
                        break
                    times.append(time.perf_counter() - t0)
                if times is None:
                    continue
                best = min(times)
                results.append({
                    "engine": engine, "n_jobs": n_jobs,
                    "best_s": round(best, 4),
                    "rows_per_s": round(total_rows / best, 1),
                })
                print(f"engine={engine:<8} jobs={n_jobs:<3} "
                      f"best={best:.4f}s  {total_rows / best:,.0f} rows/s")

    print(json.dumps({"results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
