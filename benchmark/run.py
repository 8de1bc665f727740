"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout on a machine with the cell's CUDA
devices. See benchmark/README.md and benchmark/harness/main.py.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
