"""Readings of the benchmark's control on the card, for setting the limits
of ``correct``.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

For each seed, makes the inputs that a run of the cell with that seed
makes, at the cell's own size, computes the plain reference, puts the
reference computed in bfloat16 (the nearest precision below the
configuration's float32) in the program's place, and prints what the
cell's comparison reads, one JSON line a seed. The benchmark's own runs do
not run this.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device: no readings, no fallback to the CPU", file=sys.stderr)
        return 2
    device = "cuda:0"
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    spec = harness.cell(manifest, args.workload)
    kind = harness.load_named("kinds", spec.workload["kind"])
    ref = harness.load_named("reference", spec.workload["kind"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        inputs = kind.control_inputs(spec.config, spec.workload, seed, device)
        expected = ref.reference(inputs, spec.config, spec.workload, device)
        found = ref.compare(expected, ref.control(inputs, spec.config, spec.workload, device))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": {
            k: {"value": v, "where": w, "limit": harness.limit_of(spec.workload, k)}
            for k, (v, w) in found.items()}, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
