"""Arithmetic shared by the metric files (``metrics/<name>.py``).

Each reader takes the run's record (what the cell's driver returns) and
gives a number, or None where the run has nothing to read, so that the
metric is left out of the line.  Shares are in percent.
"""

from __future__ import annotations

import math

from portbench import frozen, trace


def train_rate(run, item):
    t = run.get("train")
    if not t or t["item"] != item:
        return None
    return t["items"] / run["window_s"]


def setup_s(run):
    return run["setup_s"]


def boot_s(run):
    t = run.get("train")
    return t["boot_s"] if t else None


def device_step_ms(run):
    t = run.get("train")
    return t["device_step_ms"] if t else None


def feed_wait_frac(run):
    """``feed/wait`` spans inside the window, over the window."""
    t = run.get("train")
    if not t or t.get("feed_wait_s") is None:
        return None
    return 100.0 * t["feed_wait_s"] / run["window_s"]


def mfu(run):
    """Model FLOPs of the window's work over the window at the
    configuration's dense peak (H100 SXM, 989 TFLOP/s in bf16)."""
    work = run.get("train") or run.get("serve")
    if not work or not work.get("flops"):
        return None
    peak = frozen.PEAK_FLOPS[run["config"]["dtype"]]
    return 100.0 * work["flops"] / run["window_s"] / peak


def idle_frac(run):
    """1 - the union of device intervals over the traced stretch."""
    tr = run.get("trace")
    if not tr or not tr["device"]:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / trace.window_s(tr))


def roofline(run, kernels, bound_ms):
    """The least time of the launches whose names hold a key of
    ``kernels`` (``bound_ms(key)`` a launch), over their device time."""
    tr = run.get("trace")
    if not tr:
        return None
    spent, least = 0.0, 0.0
    for name, t0, t1 in tr["device"]:
        low = name.lower()
        key = next((k for k in kernels if k in low), None)
        if key is not None:
            spent += (t1 - t0) / 1e3
            least += bound_ms(key)
    return 100.0 * least / spent if spent else None


def _pct(values, q):
    """Nearest-rank percentile over every value (inf for a failure)."""
    vals = sorted(values)
    return vals[max(0, math.ceil(q * len(vals)) - 1)] if vals else None


def ttft_p95_ms(run):
    s = run.get("serve")
    return _pct(s["ttft_ms"], 0.95) if s else None


def itl_p95_ms(run):
    s = run.get("serve")
    return _pct(s["itl_ms"], 0.95) if s else None
