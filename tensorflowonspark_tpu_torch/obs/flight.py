"""Flight recorder: the span ring frozen to disk when something dies.

An own copy of ``tensorflowonspark_tpu/obs/flight.py``.  Every process
keeps its last ``TFOS_FLIGHT_RING`` telemetry records in memory
(``telemetry.recent``); ``snapshot`` writes them, with the trigger, the
victim and a summary of the work in flight, into one JSON file in the
process's telemetry sink, where the drain collects it and
``tfos-postmortem-torch`` reads it.  The engine snapshots on an
executor's respawn, the serving pool on a replica's death, the health
monitor on an anomaly and the obs publisher on a ``/flightz``
directive.

Bounded and redaction-safe: a dump is clipped to ``TFOS_FLIGHT_CAP``
bytes (oldest records first, their count kept in ``truncated``), at
most ``TFOS_FLIGHT_KEEP`` dumps a process are kept, and every attr is
reduced to a small scalar (a string past 200 characters is cut, any
other object named, never written).  A no-op when telemetry is off.
Stdlib only.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time

from tensorflowonspark_tpu_torch.utils import telemetry

logger = logging.getLogger(__name__)

PREFIX = "flight-"
CAP_ENV = "TFOS_FLIGHT_CAP"        # bytes a dump
WINDOW_ENV = "TFOS_FLIGHT_WINDOW"  # trailing seconds of the ring a dump
KEEP_ENV = "TFOS_FLIGHT_KEEP"      # dumps kept a process

_MAX_STR = 200      # longest attr string kept whole
_MAX_INFLIGHT = 64  # in-flight entries kept a dump
_SEQ = itertools.count(1)


def cap_default():
    return int(os.environ.get(CAP_ENV, str(256 * 1024)))


def window_default():
    return float(os.environ.get(WINDOW_ENV, "30"))


def keep_default():
    return int(os.environ.get(KEEP_ENV, "8"))


def _clean_value(v):
    if v is None or isinstance(v, (bool, int, float)):
        return v
    if isinstance(v, str):
        return v if len(v) <= _MAX_STR else v[:_MAX_STR] + "…"
    return f"<redacted {type(v).__name__}>"


def _clean_attrs(attrs):
    if not isinstance(attrs, dict):
        return {}
    return {str(k): _clean_value(v) for k, v in attrs.items()}


def _clean_record(rec):
    out = {k: rec.get(k) for k in telemetry.SCHEMA_KEYS}
    out["attrs"] = _clean_attrs(rec.get("attrs"))
    return out


def snapshot(trigger, node=None, reason=None, inflight=None,
             window_s=None):
    """Write this process's flight ring to one bounded dump file;
    returns its path, or None when telemetry is off or the sink is
    unwritable.  ``node`` names the victim (default: this process),
    ``inflight`` a list of small dicts of the work outstanding."""
    rec = telemetry._get()
    if rec is None:
        return None
    window = window_default() if window_s is None else float(window_s)
    dump = {
        "ts": time.time(),
        "trigger": str(trigger),
        "node": str(node) if node is not None else rec.node_id,
        "reason": _clean_value(reason),
        "recorded_by": {"node_id": rec.node_id, "role": rec.role,
                        "pid": rec.pid},
        "window_s": window,
        "inflight": [_clean_attrs(e)
                     for e in (inflight or [])[:_MAX_INFLIGHT]],
        "truncated": 0,
        "records": [_clean_record(r) for r in telemetry.recent(window)],
    }
    cap = max(cap_default(), 4096)
    blob = json.dumps(dump, default=str)
    while len(blob) > cap and dump["records"]:
        drop = max(1, len(dump["records"]) // 4)  # the oldest first
        dump["records"] = dump["records"][drop:]
        dump["truncated"] += drop
        blob = json.dumps(dump, default=str)
    mine = f"{PREFIX}{telemetry._safe(rec.node_id)}-{rec.pid}-"
    path = os.path.join(rec.sink_dir, f"{mine}{next(_SEQ):04d}.json")
    try:
        os.makedirs(rec.sink_dir, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(blob + "\n")
        _rotate(rec.sink_dir, mine)
    except OSError as e:
        logger.warning("flight dump unwritable (%s): %s", path, e)
        return None
    return path


def _rotate(sink_dir, mine):
    """Keep the newest ``TFOS_FLIGHT_KEEP`` dumps named ``mine*``."""
    try:
        names = sorted(n for n in os.listdir(sink_dir)
                       if n.startswith(mine) and n.endswith(".json"))
    except OSError:
        return
    for name in names[:-max(keep_default(), 1)]:
        try:
            os.remove(os.path.join(sink_dir, name))
        except OSError:
            pass
