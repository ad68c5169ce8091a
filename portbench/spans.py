"""Arithmetic over the program's own phases and feeder records, shared
by the metric files that read them (``metrics/<name>.py``).

The trainer's report (``run["report"]``) carries both:

- ``train_metrics.phases``: ``TrainMetrics``' record of each step while
  telemetry is on (a traced run): ``step`` (0-based, as ``step_ms``),
  ``input_wait`` as ``[start wall s, ms]`` (the loop's wait for the
  step's batch) and the device ms of each phase the step marked
  (``forward``, ``backward``, ``optimizer``);
- ``feeders``: the node's feeder records, one a partition, each part as
  ``[start wall s, ms]`` (``read``, ``encode`` and ``put`` a chunk each,
  ``drain``, ``partition``) beside its ``executor``.

A program that records neither gives None, and the metric is left out.
The device trace's stamps and the host's wall clock are one clock on
the card (PERF.md), so spans are laid over ``run["trace"]`` as they are.
"""

from __future__ import annotations

import collections
import statistics


def phases(run):
    rep = run.get("report") or {}
    return (rep.get("train_metrics") or {}).get("phases")


def phase_ms(run, phase):
    """The median device ms of ``phase`` over the steps from the mix's
    ``warm_steps`` on (the steps ``device_step_ms`` takes)."""
    steps = phases(run)
    if not steps:
        return None
    warm = run["traffic"]["warm_steps"]
    vals = [e[phase] for e in steps if e["step"] >= warm and phase in e]
    return statistics.median(vals) if vals else None


def merged(spans):
    """The union of ``(start, end)`` intervals, sorted, as a list."""
    out = []
    for t0, t1 in sorted(spans):
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def overlap(a, b):
    """The length two merged interval lists have in common."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_wait_frac(run):
    """The device-idle time of the traced stretch that falls inside the
    loop's input waits, over the stretch, in %: the part of
    ``idle_frac`` the step's wait for its batch explains."""
    tr, steps = run.get("trace"), phases(run)
    if not tr or not tr["device"] or not steps:
        return None
    lo, hi = tr["extent_us"]
    waits = merged(
        (max(lo, 1e6 * e["input_wait"][0]),
         min(hi, 1e6 * e["input_wait"][0] + 1e3 * e["input_wait"][1]))
        for e in steps if "input_wait" in e)
    busy = merged((t0, t1) for _, t0, t1 in tr["device"])
    idle = sum(t1 - t0 for t0, t1 in waits) - overlap(waits, busy)
    return 100.0 * idle / (hi - lo)


def feed_gap_ms(run):
    """The median, over consecutive partitions of one executor, of the
    time from a partition's drain end to the next one's first put: the
    ring stands empty at each partition boundary that long."""
    feeders = (run.get("report") or {}).get("feeders") or []
    by_executor = collections.defaultdict(list)
    for f in feeders:
        if f.get("drain") and f.get("put") and f.get("partition"):
            by_executor[f.get("executor")].append(f)
    gaps = []
    for parts in by_executor.values():
        parts.sort(key=lambda f: (f["partition"][0], f["part"]))
        for a, b in zip(parts, parts[1:]):
            drained = a["drain"][0] + a["drain"][1] / 1e3
            gaps.append(1e3 * (b["put"][0][0] - drained))
    return statistics.median(gaps) if gaps else None
