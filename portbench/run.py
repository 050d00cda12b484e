"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object; the numbers that decide ``correct`` are printed
last on standard error too. See ``portbench/bench.py``.
"""

import os
import sys
import time

T0 = time.perf_counter()  # set-up is counted from here

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench import bench

    sys.exit(bench.main(sys.argv[1:], T0))
