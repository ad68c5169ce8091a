"""On the card only: each cell's run, as the driver makes it, comes out
correct (``python -m pytest portbench/tests -q -m card``)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "10", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["kind"] == card
