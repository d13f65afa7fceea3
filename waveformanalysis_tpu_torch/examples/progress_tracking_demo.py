"""Progress tracking surface: with_progress / progress_iter / progress_map.

    python -m waveformanalysis_tpu_torch.examples.progress_tracking_demo [--device cuda]

The port's counterpart of the JAX package's examples/progress_tracking_demo.py
(reference analog: examples/progress_tracking_demo.py): decorated
generators, decorated list-returning functions, wall-time display on plain
functions, and the two functional helpers. The demo's work is host Python;
``--device`` (default ``cuda``, which raises without a card; ``--device
cpu`` on the CPU) is resolved and printed as in the other examples.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

from waveformanalysis_tpu_torch.foundation.progress import (
    format_throughput,
    format_time,
    get_global_tracker,
    progress_iter,
    progress_map,
    with_progress,
)


# -- 1. decorated generator: each yield advances the bar ---------------------
@with_progress(total=20, desc="generating items")
def generate_items():
    for i in range(20):
        time.sleep(0.01)
        yield i * i


# -- 2. decorated list-returning function ------------------------------------
@with_progress(desc="loading files")
def load_files(file_list):
    return [f"<{name}>" for name in file_list]


# -- 3. plain function: shows wall time --------------------------------------
@with_progress(desc="expensive computation")
def expensive_computation(n):
    return sum(i * i for i in range(n))


def main(device: str = "cuda") -> Dict[str, Any]:
    """Run the demo; returns the values it printed."""
    from waveformanalysis_tpu_torch.device import resolve_device

    print(f"device: {resolve_device(device)}")
    items = list(generate_items())
    print(f"generated {len(items)} items, last={items[-1]}")

    loaded = load_files([f"file_{i}.csv" for i in range(5)])
    print(f"loaded {len(loaded)}")

    total = expensive_computation(200_000)
    print(f"sum of squares: {total}")

    # -- 4. progress_iter over any iterable ----------------------------------
    acc = 0
    for x in progress_iter(range(50), desc="accumulating"):
        acc += x
    print(f"accumulated {acc}")

    # -- 5. progress_map ------------------------------------------------------
    squares = progress_map(lambda v: v * v, list(range(10)), desc="mapping")
    print(f"squares tail: {squares[-3:]}")

    # -- 6. the global tracker + formatting helpers ---------------------------
    tracker = get_global_tracker()
    print(f"tracker: {type(tracker).__name__}")
    print("format_time(4000s):", format_time(4000))
    print("format_throughput:", format_throughput(1_234_567, "wf"))
    return {"items": len(items), "last": items[-1], "loaded": len(loaded),
            "total": total, "accumulated": acc, "squares_tail": squares[-3:],
            "tracker": type(tracker).__name__, "time": format_time(4000),
            "throughput": format_throughput(1_234_567, "wf")}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
