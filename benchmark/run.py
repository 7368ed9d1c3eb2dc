"""Run one cell of the benchmark once, from the root of a checkout::

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line on standard output is the run's result as one JSON object;
the last lines on standard error are the output check's numbers beside
their limits.  Needs an NVIDIA GPU (exits with 2 and no result without
one).
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
