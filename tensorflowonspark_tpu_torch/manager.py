"""Per-executor IPC manager: named queues plus a key/value store.

An own copy of the part of ``tensorflowonspark_tpu/manager.py`` that the
SPARK-fed training path calls.  A ``multiprocessing.managers.BaseManager``
per executor serves the feed queues ('input', 'output', 'error',
'control') and a KV store (the node's 'state': running / terminating /
stopped, the trainer's pid and heartbeat) over loopback TCP, to the
feeder tasks and the trainer that share the executor.  Queue items are
chunks (lists of records), one IPC hop per chunk.

Left out: the 'remote' mode that ps/evaluator nodes use, and the
telemetry-drain and live-metrics channels (ROADMAP.md queue 1, items 20
and 21).
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from multiprocessing.managers import BaseManager, DictProxy

from tensorflowonspark_tpu_torch.utils import track_child_pid

logger = logging.getLogger(__name__)

HEARTBEAT_KEY = "heartbeat"
HEARTBEAT_SECS = 2.0         # beat cadence
HEARTBEAT_STALE_SECS = 60.0  # beat age past which the consumer is dead


def heartbeat_age(mgr):
    """Seconds since the consumer last beat, or None when it never beat
    (or the KV is unreadable): None means unknown, not dead."""
    try:
        v = mgr.get(HEARTBEAT_KEY)
    except Exception:  # noqa: BLE001 - manager may be tearing down
        return None
    if v is None:
        return None
    try:
        return max(0.0, time.time() - float(v))
    except (TypeError, ValueError):
        return None


def start_heartbeat(mgr):
    """A daemon thread that writes the time into the KV every
    ``HEARTBEAT_SECS``; returns the Event that stops it.  The trainer
    runs one for the life of the user's ``main_fun``, so a feeder can
    tell a dead consumer (stale beat) from a slow one."""
    stop = threading.Event()

    def _run():
        while not stop.is_set():
            try:
                mgr.set(HEARTBEAT_KEY, time.time())
            except Exception:  # noqa: BLE001 - manager gone: node exiting
                return
            stop.wait(HEARTBEAT_SECS)

    threading.Thread(target=_run, name="tfos-heartbeat", daemon=True).start()
    return stop


class TFManager(BaseManager):
    """Manager with ``get``/``set`` over one cached KV proxy (creating a
    proxy costs several round trips; the cached one is thread-safe)."""

    def _kv(self):
        p = getattr(self, "_kv_proxy", None)
        if p is None:
            p = self._kv_proxy = self.kv()
        return p

    def get(self, key):
        return self._kv().get(key)

    def set(self, key, value):
        self._kv().update({key: value})


# Server-side state, created lazily inside the manager's server process.
_qdict = {}
_kdict = {}


def _get_queue(name):
    if name not in _qdict:
        _qdict[name] = _queue.Queue()
    return _qdict[name]


def _get_kv():
    return _kdict


def start(authkey, queues, mode="local"):
    """Start this executor's manager on loopback; returns it (its
    ``.address`` is (host, port)).  Its server process is recorded as a
    child of the executor, so the engine's teardown can kill it."""
    if mode != "local":
        raise NotImplementedError(
            "remote managers (ps/evaluator nodes) come with ROADMAP.md "
            "queue 1, item 20")
    TFManager.register("get_queue", callable=_get_queue)
    TFManager.register("kv", callable=_get_kv, proxytype=DictProxy)
    mgr = TFManager(address=("localhost", 0), authkey=authkey)
    mgr.start()
    proc = getattr(mgr, "_process", None)
    if proc is not None and proc.pid:
        track_child_pid(proc.pid)
    for name in queues:  # the queues exist before any consumer asks
        mgr.get_queue(name)
    mgr.set("state", "running")
    logger.info("started TFManager on %s", mgr.address)
    return mgr


def connect(address, authkey):
    """Connect to a running manager."""
    TFManager.register("get_queue")
    TFManager.register("kv", proxytype=DictProxy)
    if not isinstance(authkey, bytes):
        authkey = bytes(authkey, "utf-8")
    m = TFManager(address=tuple(address), authkey=authkey)
    m.connect()
    return m
