"""Run one cell of the port's benchmark once.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA devices.
The last line of standard output is the result as one JSON object; the
numbers compared with the plain reference are the last lines of standard
error.  Without the devices it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from h100bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
