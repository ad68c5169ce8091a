"""A profiler capture reduced to what the readers and the result need.

``compact(prof)`` keeps every device interval (kernels, copies, sets)
as ``[name, start_us, end_us]``, the capture's extent, and for the
longest idle gaps the host operation that was running across each.
The idle share is the union of device intervals over the extent
(``frozen._union``, as ``chip_smoke.device_breakdown`` takes it).
"""

from __future__ import annotations

import collections

from portbench.frozen import _union


def _events(prof):
    """(device, host) lists of (name, start_us, end_us, is_annotation)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns() / 1e3
        t1 = t0 + e.duration_ns() / 1e3
        row = (e.name(), t0, t1)
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                dev.append(row)
        elif not e.is_user_annotation() and not getattr(
                e, "is_python_function", lambda: False)():
            host.append(row)
    return dev, host


def _merged(spans):
    out = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def compact(prof, gaps=10):
    dev, host = _events(prof)
    stamps = [t for _, t0, t1 in dev + host for t in (t0, t1)]
    lo, hi = (min(stamps), max(stamps)) if stamps else (0.0, 0.0)
    merged = _merged([(t0, t1) for _, t0, t1 in dev])
    holes = []
    prev = lo
    for t0, t1 in merged:
        if t0 > prev:
            holes.append((prev, t0))
        prev = max(prev, t1)
    if hi > prev:
        holes.append((prev, hi))
    holes.sort(key=lambda g: g[1] - g[0], reverse=True)
    named = []
    for g0, g1 in holes[:gaps]:
        mid = 0.5 * (g0 + g1)
        inner = [(t1 - t0, name) for name, t0, t1 in host if t0 <= mid <= t1]
        named.append([min(inner)[1] if inner else "host idle",
                      (g1 - g0) / 1e6])
    return {"device": [[n, t0, t1] for n, t0, t1 in dev],
            "extent_us": [lo, hi], "idle_gaps": named}


def busy_s(tr):
    return _union([(t0, t1) for _, t0, t1 in tr["device"]]) / 1e6


def window_s(tr):
    lo, hi = tr["extent_us"]
    return (hi - lo) / 1e6


def breakdown(tr, top=10):
    """The result's ``breakdown``: the device operations that took most
    time, and the longest idle gaps by what the host was doing."""
    ops = collections.Counter()
    for name, t0, t1 in tr["device"]:
        ops[name[:120]] += (t1 - t0) / 1e6
    return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
            "idle_gaps": tr["idle_gaps"][:top]}
