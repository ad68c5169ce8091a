"""The port's benchmark: one run of one cell.

A cell (``cells/<name>.json``) names its configuration
(``configs/<name>.json``), its traffic mix (``traffic/<name>.json``)
and the limits of its correctness check.  The mix names the general
driver that runs it (``drivers/<name>.py``).  The metrics a cell
reports are those ``BENCHMARK.json`` gives it, each read by its own
file (``metrics/<name>.py``, ``read(run) -> number or None``).  So a
new configuration, mix, cell or metric is a new file, and no file here
changes.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

PB = Path(__file__).resolve().parent
ROOT = PB.parent
# top-level module names the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "tensorflowonspark_tpu")


class RunError(RuntimeError):
    """The run could not be measured; nothing is printed on stdout."""


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's three files, the run's arguments,
    a private directory, and the process's start on the host clock."""
    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    run_dir: str
    t0: float
    device: str = "cuda"
    controls: bool = False   # also read the control and the faults

    def log(self, msg):
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_json(kind, name):
    path = PB / kind / f"{name}.json"
    if not path.is_file():
        raise RunError(f"no {kind[:-1]} file {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_module(kind, name):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = PB / kind / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no {kind[:-1]} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench, cell):
    """The cell's end-to-end and per-layer metric entries, as
    ``BENCHMARK.json`` assigns them: a listed ``workloads`` names the
    cell, or, without one, an end-to-end metric is every cell's and a
    per-layer metric every cell's that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def process_start():
    """This process's start on the host clock (``/proc``; else now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return None


MARK = "PORTBENCH_RUN"  # set for the run; its processes inherit it


def descendants(mark):
    """Live processes that carry this run's mark in their environment
    (the executors, the trainer, their children, orphaned or not), but
    multiprocessing's resource tracker, which ends with this process."""
    me, want = os.getpid(), f"{MARK}={mark}".encode()
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == me:
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if want not in f.read().split(b"\0"):
                    continue
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    continue
        except (OSError, IndexError):
            continue
        if "resource_tracker" not in _cmdline(pid):
            out.append(int(pid))
    return out


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode()[:120]
    except OSError:
        return ""


def _listing(path, prefix=""):
    try:
        return {n for n in os.listdir(path) if n.startswith(prefix)}
    except OSError:
        return set()


def leftovers(before_tmp, before_shm, base, mark):
    """What the run left behind: live processes it started, feed rings
    in ``/dev/shm``, entries in its temporary directory."""
    return {"processes": [(p, _cmdline(p)) for p in descendants(mark)],
            "rings": sorted(_listing("/dev/shm", "tfos") - before_shm),
            "tmp": sorted(_listing(base) - before_tmp)}


def chips_ok(n):
    import torch

    return torch.cuda.is_available() and torch.cuda.device_count() >= n


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metrics(entries, run):
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name, seed, seconds, trace, *, device="cuda", t0=None,
             bench=None, overrides=None, controls=False):
    """One run: returns the result dict (the line the run prints)."""
    t0 = t0 if t0 is not None else time.time()
    bench = bench if bench is not None else json.loads(
        (ROOT / "BENCHMARK.json").read_text())
    o = overrides or {}
    cell = o.get("cell") or load_json("cells", name)
    config = o.get("config") or load_json("configs", cell["config"])
    traffic = o.get("traffic") or load_json("traffic", cell["traffic"])
    e2e, layer = metrics_for(bench, name)
    if device == "cuda" and not chips_ok(cell["chips"]):
        raise RunError(f"the cell asks for {cell['chips']} CUDA device(s); "
                       "this machine has fewer")
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    before_tmp, before_shm = _listing(base), _listing("/dev/shm", "tfos")
    run_dir = tempfile.mkdtemp(prefix="portbench-", dir=base)
    ctx = Context(name, cell, config, traffic, int(seed), float(seconds),
                  bool(trace), run_dir, t0, device, controls)
    os.environ[MARK] = run_dir
    try:
        driver = load_module("drivers", traffic["driver"])
        run = driver.run(ctx)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    metrics = read_metrics(layer if trace else e2e, run)
    left = leftovers(before_tmp, before_shm, base, run_dir)
    print(f"[portbench] left behind: {json.dumps(left)}", file=sys.stderr,
          flush=True)
    checks = dict(run["checks"], leftovers={
        "value": float(sum(map(len, left.values()))), "limit": 0.0})
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics,
           "device": dict(run["device"])}
    if trace:
        from portbench import trace as tr

        if run.get("trace"):
            out["device"]["busy_s"] = tr.busy_s(run["trace"])
            out["device"]["window_s"] = tr.window_s(run["trace"])
            out["breakdown"] = tr.breakdown(run["trace"])
    if controls:
        out["controls"] = run.get("controls")
        out["numbers"] = run.get("numbers")
    out["checks"] = checks
    return out


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def setup_env():
    """No library loads JAX on its own; torch's compile caches sit at
    fixed paths inside the checkout."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for env, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(env, str(ROOT / "build" / "portbench" / sub))


def main(argv, t0=None):
    args = parse(argv)
    t0 = process_start() or t0 or time.time()
    setup_env()
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t0=t0)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr,
              flush=True)
        return 3
    for k, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr, flush=True)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0
