"""Run one benchmark cell once on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells are those of BENCHMARK.json; the
last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, then the numbers
compared beside their limits). Exits non-zero, with no result, without the
CUDA devices the cell asks for.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
