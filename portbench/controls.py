"""Readings of a cell's control and faults on the chip, beside the
program's own, one full run a seed::

    python3 portbench/controls.py --workload <cell> --seeds 11,12,13 \\
        --seconds 10

Each run prints the program's numbers and, computed on the same rows
or requests, those of the plain reference run in the next precision
below the configuration's (float8 e4m3 operands for bf16) and, for a
training cell, of the reference fed half of each batch.  The limits in
``cells/<cell>.json`` are set between the program's readings (the lower
end) and these (the upper end); ``PERF.md`` keeps both.  The benchmark's
own runs do not run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10)
    a = p.parse_args()
    harness.setup_env()
    for seed in (int(s) for s in a.seeds.split(",")):
        out = harness.run_cell(a.workload, seed, a.seconds, False,
                               controls=True)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "program": out["numbers"],
                          "controls": out["controls"],
                          "metrics": out["metrics"]}), flush=True)
        import torch

        torch.cuda.empty_cache()
