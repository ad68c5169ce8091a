"""A configuration, a mix, a cell and a per-layer metric come in as
files of their own: in a copy of the benchmark, adding them (and their
``BENCHMARK.json`` entries) runs the new cell with the new metric, and
no file that was there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench.tests import tiny

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent


def _digests(d):
    return {str(p.relative_to(d)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_mix_cell_and_metric_as_files(tmp_path):
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    os.symlink(ROOT / "tensorflowonspark_tpu_torch",
               tmp_path / "tensorflowonspark_tpu_torch")
    before = _digests(tmp_path / "portbench")
    bench_before = (tmp_path / "BENCHMARK.json").read_text()

    new = tmp_path / "portbench"
    (new / "configs" / "tiny-lm.json").write_text(json.dumps(tiny.LM))
    (new / "traffic" / "train.tiny.json").write_text(
        json.dumps(tiny.LM_TRAIN))
    (new / "cells" / "tiny-lm.train.tiny.json").write_text(json.dumps(
        {"config": "tiny-lm", "traffic": "train.tiny", "chips": 1,
         "why": "a test cell", "limits": tiny.TRAIN_LIMITS}))
    (new / "metrics" / "window_steps.train_tiny.py").write_text(
        '"""Steps in the window."""\n\n\ndef read(run):\n'
        '    return float(run["train"]["steps"])\n')
    bench = json.loads(bench_before)
    bench["workloads"].append({"name": "tiny-lm.train.tiny",
                               "config": "tiny-lm", "traffic": "train.tiny",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({
        "name": "window_steps.train_tiny", "unit": "steps",
        "better": "higher", "source": "host_clock", "layer": "train loop",
        "moves": "train_tokens_per_s", "workloads": ["tiny-lm.train.tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tiny-lm.train.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json, sys; sys.path.insert(0, '.');"
            "from portbench import harness;"
            "out = harness.run_cell('tiny-lm.train.tiny', 5, 2, 1,"
            " device='cpu'); print(json.dumps(out))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["metrics"]["window_steps.train_tiny"]["value"] >= 1
    after = _digests(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "configs/tiny-lm.json", "traffic/train.tiny.json",
        "cells/tiny-lm.train.tiny.json",
        "metrics/window_steps.train_tiny.py"}


def test_cell_without_chip_prints_no_result(tmp_path):
    """Without the card the run exits non-zero and prints nothing on
    standard output; in a directory of only the benchmark's files, too."""
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copytree(PB, tmp_path / "portbench",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        proc = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "pythia-2.8b.train.spark", "--seed", "3", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert proc.returncode != 0 and proc.stdout.strip() == ""
