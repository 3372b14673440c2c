"""Run one cell of the port's benchmark once::

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs as many CUDA cards as the cell asks for; without them it exits
with code 2 and prints no result. See port_bench/harness.py."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this script's folder, whose module
# names (trace, ...) would shadow others
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from port_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
