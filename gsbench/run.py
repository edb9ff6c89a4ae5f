"""Run one cell of the benchmark once:

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the port.
Prints the result as one JSON line, last on standard output.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from gsbench import harness  # noqa: E402

if __name__ == "__main__":
    os.chdir(ROOT)
    raise SystemExit(harness.main(sys.argv[1:], T_START, ROOT))
