"""Keyed KV-heartbeat liveness.

An own copy of ``tensorflowonspark_tpu/actors/liveness.py``: N members
(the serving replicas) beat under their own keys through one manager
KV (``manager.TFManager.get``/``set``), and the supervisor reads each
key's age to tell a wedged member from a slow one.

The cadence and the staleness threshold come from
``TFOS_ACTOR_HEARTBEAT_SECS`` / ``TFOS_ACTOR_HEARTBEAT_STALE`` (the
``TFOS_HEARTBEAT_*`` aliases honoured), defaulting to the trainer
heartbeat's ``manager.HEARTBEAT_SECS`` and ``HEARTBEAT_STALE_SECS``.
"""

from __future__ import annotations

import threading
import time

from tensorflowonspark_tpu_torch import manager as tfmanager

__all__ = ["beat", "beat_age", "heartbeat_interval", "scan",
           "stale_after", "start_heartbeat"]


heartbeat_interval = tfmanager.heartbeat_interval
stale_after = tfmanager.stale_after


def beat(mgr, key):
    """Record liveness under ``key`` now."""
    mgr.set(key, time.time())


def beat_age(mgr, key):
    """Seconds since the last beat under ``key``; None = never beat (or
    KV unreadable) — callers treat None as 'unknown', never 'dead'."""
    try:
        v = mgr.get(key)
    except Exception:  # noqa: BLE001 - manager tearing down
        return None
    if v is None:
        return None
    try:
        return max(0.0, time.time() - float(v))
    except (TypeError, ValueError):
        return None


def start_heartbeat(mgr, key, interval=None):
    """Daemon thread beating ``key`` every ``interval`` (default:
    :func:`heartbeat_interval`); returns a stop Event.  The thread exits
    silently when the manager goes away — the process is ending."""
    interval = heartbeat_interval() if interval is None else float(interval)
    stop = threading.Event()

    def _run():
        while not stop.is_set():
            try:
                beat(mgr, key)
            except Exception:  # noqa: BLE001 - manager gone: member exiting
                return
            stop.wait(interval)

    threading.Thread(target=_run, name="tfos-actor-beat",
                     daemon=True).start()
    return stop


def scan(indices, proc_alive, age_of, stale_secs):
    """One liveness sweep: ``[(idx, why)]`` members to declare lost.

    ``proc_alive(idx)`` is the fast path (executor process death);
    ``age_of(idx)`` the wedged-member path (beating stopped while the
    process lives).  A member is lost on either signal."""
    lost = []
    for idx in indices:
        if not proc_alive(idx):
            lost.append((idx, "process death"))
            continue
        age = age_of(idx)
        if age is not None and age > stale_secs:
            lost.append((idx, f"heartbeat stale ({age:.1f}s)"))
    return lost
