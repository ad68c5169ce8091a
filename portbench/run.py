"""Run one cell of the port's benchmark once, from the checkout's root::

    python3 portbench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The last line of standard output is the result; the correctness
check's numbers, each beside its limit, are the last lines of standard
error.  See ``portbench/README.md``.
"""

import os
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], t0=T0))
