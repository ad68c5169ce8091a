"""Declared service-level objectives and their error-budget burn.

An own copy of ``tensorflowonspark_tpu/obs/slo.py``.  Objectives are
declared once (``TFOS_SLO``, default ``DEFAULT_SPEC``) and evaluated
over the registry snapshots the driver's ``ObsServer`` polls: the
``tfos_slo_*`` series of the driver's registry, the ``slo`` section of
``/statusz``, ``/slo`` and ``tfos-top-torch --slo``.

Grammar (``;``-separated)::

    entry := name ":latency:" histogram "<" threshold_ms "@" good_pct
           | name ":availability:" counter "@" good_pct

A latency objective asks that ``good_pct`` % of a histogram's
observations (summed over the nodes) be at most ``threshold_ms``; an
availability objective that ``good_pct`` % of a status-labelled
counter's outcomes be ``status="ok"``.  The burn rate is the bad
fraction over the allowed one (``1 - good_pct/100``): above 1 the
budget is being spent faster than the objective allows, and each
transition into that state counts in ``tfos_slo_breaches_total``.  A
malformed spec disables the engine with a logged error.  Stdlib only.
"""

from __future__ import annotations

import logging
import math
import os
import time

from tensorflowonspark_tpu_torch.utils import metrics_registry

logger = logging.getLogger(__name__)

SPEC_ENV = "TFOS_SLO"
DEFAULT_SPEC = ("decode_ttft:latency:tfos_decode_ttft_ms<500@99;"
                "serve_availability:availability:tfos_serve_requests_total@99")
KINDS = ("latency", "availability")


class Objective:
    """One parsed entry of the spec."""

    __slots__ = ("name", "kind", "metric", "threshold_ms", "target")

    def __init__(self, name, kind, metric, threshold_ms, target):
        self.name = name
        self.kind = kind
        self.metric = metric
        self.threshold_ms = threshold_ms  # None for availability
        self.target = target              # the good fraction, 0..1

    def __repr__(self):
        pct = f"{self.target * 100:g}"
        if self.kind == "latency":
            return (f"{self.name}:latency:{self.metric}"
                    f"<{self.threshold_ms:g}@{pct}")
        return f"{self.name}:availability:{self.metric}@{pct}"


def _number(entry, what, text):
    try:
        return float(text)
    except ValueError:
        raise ValueError(f"slo entry {entry!r}: non-numeric {what} "
                         f"{text!r}") from None


def parse_spec(spec):
    """A ``TFOS_SLO`` string as a list of :class:`Objective`; raises
    ``ValueError`` on a malformed entry."""
    objectives = []
    for raw in str(spec or "").split(";"):
        entry = raw.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) != 3:
            raise ValueError(f"slo entry {entry!r}: expected name:kind:spec")
        name, kind, rest = (p.strip() for p in parts)
        if not name:
            raise ValueError(f"slo entry {entry!r}: empty name")
        if kind not in KINDS:
            raise ValueError(f"slo entry {entry!r}: unknown kind {kind!r} "
                             f"(valid: {', '.join(KINDS)})")
        rest, sep, pct_s = rest.partition("@")
        if not sep:
            raise ValueError(f"slo entry {entry!r}: missing @good_pct")
        pct = _number(entry, "target", pct_s)
        if not 0.0 < pct < 100.0:
            raise ValueError(
                f"slo entry {entry!r}: target must be in (0, 100)")
        threshold, metric = None, rest.strip()
        if kind == "latency":
            metric, sep, thr_s = metric.partition("<")
            if not sep:
                raise ValueError(f"slo entry {entry!r}: latency needs "
                                 "metric<threshold_ms")
            threshold = _number(entry, "threshold", thr_s)
            metric = metric.strip()
        if not metric:
            raise ValueError(f"slo entry {entry!r}: empty metric name")
        objectives.append(Objective(name, kind, metric, threshold,
                                    pct / 100.0))
    return objectives


def merge_histogram(snaps, metric):
    """One histogram metric's series summed over the snapshots (the
    ``quantile`` input); a series whose bounds differ from the first is
    skipped.  None when no snapshot has the metric."""
    merged = None
    for snap in snaps:
        for s in ((snap or {}).get(metric) or {}).get("series", ()):
            if "count" not in s:
                continue
            bounds = list(s.get("bounds", ()))
            if merged is None:
                merged = {"bounds": bounds,
                          "counts": list(s.get("counts", ())),
                          "sum": float(s.get("sum", 0.0)),
                          "count": int(s.get("count", 0))}
                continue
            if bounds != merged["bounds"]:
                logger.debug("slo: %s series with mismatched buckets "
                             "skipped", metric)
                continue
            for i, c in enumerate(s.get("counts", ())):
                if i < len(merged["counts"]):
                    merged["counts"][i] += c
            merged["sum"] += float(s.get("sum", 0.0))
            merged["count"] += int(s.get("count", 0))
    return merged


def fraction_over(series, threshold):
    """The fraction of a histogram's observations above ``threshold``,
    interpolated inside its bucket (the +Inf bucket counts as over);
    None for an empty series."""
    count = series.get("count", 0) if series else 0
    if not count:
        return None
    bounds = list(series.get("bounds", ()))
    cum = lo = 0.0
    for i, c in enumerate(series.get("counts", ())):
        hi = bounds[i] if i < len(bounds) else math.inf
        if threshold <= hi:
            if hi == math.inf or hi <= lo:
                under = cum  # an open-ended bucket counts as over
            else:
                under = cum + c * (threshold - lo) / (hi - lo)
            return max(0.0, min(1.0, (count - under) / count))
        cum += c
        lo = hi
    return 0.0


def counter_outcomes(snaps, metric):
    """``(good, total)`` over every series of a status-labelled counter:
    ``status="ok"`` (or no status) is good."""
    good = total = 0.0
    for snap in snaps:
        for s in ((snap or {}).get(metric) or {}).get("series", ()):
            if "value" not in s:
                continue
            v = float(s.get("value", 0.0))
            total += v
            if s.get("labels", {}).get("status", "ok") == "ok":
                good += v
    return good, total


def evaluate(objective, snaps):
    """One objective over a list of snapshots, as a report row; its
    ``burn`` and ``current`` stay None until the metric has samples."""
    allowed = max(1e-9, 1.0 - objective.target)
    row = {"name": objective.name, "kind": objective.kind,
           "metric": objective.metric,
           "target_pct": round(objective.target * 100.0, 4),
           "current": None, "burn": None, "breaching": False,
           "samples": 0}
    if objective.kind == "latency":
        row["threshold_ms"] = objective.threshold_ms
        hist = merge_histogram(snaps, objective.metric)
        over = fraction_over(hist, objective.threshold_ms)
        if over is None:
            return row
        row["samples"] = hist["count"]
        q = metrics_registry.quantile(hist, objective.target)
        row["current"] = None if q is None else round(q, 3)
        row["burn"] = round(over / allowed, 4)
    else:
        good, total = counter_outcomes(snaps, objective.metric)
        if not total:
            return row
        row["samples"] = int(total)
        row["current"] = round(good / total, 6)
        row["burn"] = round((1.0 - good / total) / allowed, 4)
    row["breaching"] = bool(row["burn"] is not None and row["burn"] > 1.0)
    return row


class Engine:
    """The parsed objectives and their breach edges; ``step`` evaluates
    them, publishes the ``tfos_slo_*`` series and keeps the report."""

    def __init__(self, spec=None):
        if spec is None:
            spec = os.environ.get(SPEC_ENV, DEFAULT_SPEC)
        try:
            self.objectives = parse_spec(spec)
        except ValueError:
            logger.exception("invalid %s=%r; slo engine disabled",
                             SPEC_ENV, spec)
            self.objectives = []
        self._breaching = {}
        self._report = {"ts": None, "objectives": []}

    def step(self, snaps, emit=True):
        rows = [evaluate(o, snaps) for o in self.objectives]
        if emit:
            for row in rows:
                if row["burn"] is None:
                    continue
                name = row["name"]
                metrics_registry.set_gauge("tfos_slo_burn_rate", row["burn"],
                                           objective=name)
                if row["current"] is not None:
                    metrics_registry.set_gauge("tfos_slo_current",
                                               row["current"],
                                               objective=name)
                if row["breaching"] and not self._breaching.get(name):
                    metrics_registry.inc("tfos_slo_breaches_total",
                                         objective=name)
                self._breaching[name] = row["breaching"]
        self._report = {"ts": time.time(), "objectives": rows}
        return self._report

    def report(self):
        """The latest report (empty before the first ``step``)."""
        return self._report
