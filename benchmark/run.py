"""Run one cell of the benchmark once (see benchmark/README.md):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
