"""Per-executor IPC manager: named queues plus a key/value store.

An own copy of the part of ``tensorflowonspark_tpu/manager.py`` that the
SPARK-fed training path calls.  A ``multiprocessing.managers.BaseManager``
per executor serves the feed queues ('input', 'output', 'error',
'control') and a KV store (the node's 'state': running / terminating /
stopped, the trainer's pid and heartbeat, the advertised feed ring)
over loopback TCP, to the feeder tasks and the trainer that share the
executor.  Queue items are chunks, one IPC hop per chunk; the 'input'
chunks take the node's shm ring instead when it advertises one
(``feed.open_feed_ring``).

``mode="remote"`` binds every interface, so that the driver can reach
a ps or evaluator node's control queue.

Three channels of the observability plane go over the KV, each on keys
unique to the writer (no read-modify-write across processes): the
telemetry drain (every process on the executor advertises its spool
under ``telemetry_spool:<path>``; the driver's drain asks for the set),
the live metrics (each publisher's registry snapshot under
``obs:<node id>``, which the driver's ``ObsServer`` polls) and the
on-demand control plane (one directive slot ``obsctl:<node id>`` that
the node's publisher pops, and one ack slot ``obsack:<node id>``).
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import queue as _queue
import threading
import time
from multiprocessing.managers import BaseManager, DictProxy

from tensorflowonspark_tpu_torch.utils import track_child_pid

logger = logging.getLogger(__name__)

HEARTBEAT_KEY = "heartbeat"
HEARTBEAT_SECS = 2.0         # beat cadence
HEARTBEAT_STALE_SECS = 60.0  # beat age past which the consumer is dead

SPOOL_KEY = "telemetry_spool:"  # + spool path: the drain channel
OBS_KEY = "obs:"                # + node id: a registry snapshot
CTL_KEY = "obsctl:"             # + node id: a control directive
ACK_KEY = "obsack:"             # + node id: the directive's result


def heartbeat_interval():
    """Beat cadence in seconds: ``TFOS_ACTOR_HEARTBEAT_SECS``, else its
    alias ``TFOS_HEARTBEAT_SECS``, else ``HEARTBEAT_SECS``.  Every
    liveness producer (trainer, replica and actor beats) reads it."""
    return float(os.environ.get(
        "TFOS_ACTOR_HEARTBEAT_SECS",
        os.environ.get("TFOS_HEARTBEAT_SECS", HEARTBEAT_SECS)))


def stale_after():
    """Heartbeat age (seconds) past which a member counts as dead:
    ``TFOS_ACTOR_HEARTBEAT_STALE``, else its alias
    ``TFOS_HEARTBEAT_STALE``, else ``HEARTBEAT_STALE_SECS``."""
    return float(os.environ.get(
        "TFOS_ACTOR_HEARTBEAT_STALE",
        os.environ.get("TFOS_HEARTBEAT_STALE", HEARTBEAT_STALE_SECS)))


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
    :func:`heartbeat_interval`; returns the Event that stops it.  The trainer
    runs one for the life of the user's ``main_fun``, so a feeder can
    tell a dead consumer (stale beat) from a slow one."""
    stop = threading.Event()
    interval = heartbeat_interval()

    def _run():
        while not stop.is_set():
            try:
                mgr.set(HEARTBEAT_KEY, time.time())
            except Exception:  # noqa: BLE001 - manager gone: node exiting
                return
            stop.wait(interval)

    threading.Thread(target=_run, name="tfos-heartbeat", daemon=True).start()
    return stop


class TFManager(BaseManager):
    """Manager with ``get``/``set`` over one cached KV proxy and cached
    queue proxies (``queue``): creating a proxy costs several round
    trips; a proxy opens one connection for each thread that uses it."""

    def _kv(self):
        p = getattr(self, "_kv_proxy", None)
        if p is None:
            p = self._kv_proxy = self.kv()
        return p

    def get(self, key):
        return self._kv().get(key)

    def set(self, key, value):
        self._kv().update({key: value})

    # -- the observability plane's channels

    def telemetry_register(self, path):
        self._kv().update({SPOOL_KEY + str(path): str(path)})

    def telemetry_spools(self):
        return sorted(v for k, v in self._kv().items()
                      if str(k).startswith(SPOOL_KEY))

    def obs_publish(self, node_id, payload):
        self._kv().update({OBS_KEY + str(node_id): payload})

    def obs_snapshots(self):
        return {str(k)[len(OBS_KEY):]: v for k, v in self._kv().items()
                if str(k).startswith(OBS_KEY)}

    def obs_control_post(self, node_id, directive):
        self._kv().update({CTL_KEY + str(node_id): directive})

    def obs_control_take(self, node_id):
        """Pop the node's directive: the proxy's ``pop`` is one call in
        the manager, so a directive is taken once."""
        return self._kv().pop(CTL_KEY + str(node_id), None)

    def obs_control_ack(self, node_id, result):
        self._kv().update({ACK_KEY + str(node_id): result})

    def obs_control_result(self, node_id):
        return self._kv().get(ACK_KEY + str(node_id))

    def queue(self, name):
        """Queue ``name``'s proxy, made once for this manager object:
        each new proxy costs a connection and its handshakes over
        loopback TCP (tens of ms or more)."""
        proxies = self.__dict__.setdefault("_queue_proxies", {})
        if name not in proxies:
            proxies[name] = self.get_queue(name)
        return proxies[name]


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
    """Start this executor's manager; returns it (its ``.address`` is
    (host, port)).  ``mode``: "local" listens on loopback, "remote" on
    every interface (ps and evaluator nodes, whose control queue the
    driver reaches).  Its server process is recorded as a child of the
    executor, so the engine's teardown can kill it.

    The server is forked.  A spawned process (every engine executor)
    inherits ``spawn`` as its default start method, and a spawned server
    imports the driver's main module again before it serves: seconds for
    a driver that imports torch, at every node's boot."""
    if mode not in ("local", "remote"):
        raise ValueError(f"mode must be 'local' or 'remote', got {mode!r}")
    TFManager.register("get_queue", callable=_get_queue)
    TFManager.register("kv", callable=_get_kv, proxytype=DictProxy)
    host = "localhost" if mode == "local" else ""
    mgr = TFManager(address=(host, 0), authkey=authkey,
                    ctx=multiprocessing.get_context("fork"))
    mgr.start()
    proc = getattr(mgr, "_process", None)
    if proc is not None and proc.pid:
        track_child_pid(proc.pid)
    for name in queues:  # the queues exist before any consumer asks
        mgr.get_queue(name)
    mgr.set("state", "running")
    logger.info("started TFManager on %s (mode=%s)", mgr.address, mode)
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
