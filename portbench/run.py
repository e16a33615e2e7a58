"""Run one cell of the port's benchmark (BENCHMARK.json at the root).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line on standard output is the result (JSON); the numbers
compared to decide `correct` are the last lines on standard error.
"""

import os
import sys
import time


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - process_age_s()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repository's root, not this folder, leads the module path
sys.path[0] = ROOT

if __name__ == "__main__":
    from portbench.harness import main
    sys.exit(main(sys.argv[1:], T0, ROOT))
