"""Node-side metrics publisher and the node end of the control plane.

An own copy of ``tensorflowonspark_tpu/obs/publish.py``.  A process
that holds its node's manager (the trainer, ``node._run_main``) runs
``start_publisher``: a daemon thread that, every ``TFOS_OBS_INTERVAL``,
ships ``metrics_registry.snapshot()`` into the manager's KV under
``obs:<node id>``, where the driver's ``ObsServer`` polls it, and then
serves at most one directive the driver posted under
``obsctl:<node id>`` (``serve_control``):

- ``profile``: a ``utils.profiler`` capture of ``ms`` milliseconds
  (at most ``MAX_PROFILE_MS``) into a ``profile-<node>-<pid>`` directory
  of the telemetry sink (else of the temp dir).  It runs on the
  publisher's thread, so the trace holds the card's side of the steps
  (every kernel and copy) and not the train loop's CPU ops;
- ``flight``: a flight-recorder dump.

The result goes back under ``obsack:<node id>`` with the directive's
sequence number.  Best effort throughout: a dead manager ends the
thread quietly, a failed directive acks its error.  Nothing runs when
``TFOS_OBS_PORT`` is unset.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time

from tensorflowonspark_tpu_torch.utils import metrics_registry, telemetry

logger = logging.getLogger(__name__)

MAX_PROFILE_MS = 60_000  # the longest capture a directive gets


def publish_once(mgr, node_id, role=None):
    """Ship this process's registry snapshot into the manager's KV;
    True when it landed."""
    snap = metrics_registry.snapshot()
    if snap is None:
        return False
    payload = {"ts": time.time(), "node_id": str(node_id),
               "role": str(role or "proc"), "pid": os.getpid(),
               "metrics": snap}
    try:
        mgr.obs_publish(str(node_id), payload)
        return True
    except Exception as e:  # noqa: BLE001 - publishing is best-effort
        logger.debug("obs publish failed for %s: %s", node_id, e)
        return False


def _capture_dir(node_id):
    """Where a capture lands: the telemetry sink when tracing is on (the
    drain collects it), else the temp dir; the ack names it."""
    rec = telemetry._get()
    base = rec.sink_dir if rec is not None else tempfile.gettempdir()
    return os.path.join(base, f"profile-{node_id}-{os.getpid()}")


def _profile(d, ack):
    from tensorflowonspark_tpu_torch.utils import profiler

    ms = min(max(int(d.get("ms") or 1000), 1), MAX_PROFILE_MS)
    out = _capture_dir(ack["node_id"])
    started = profiler.start_trace(out)
    time.sleep(ms / 1000.0)
    if started:
        started = profiler.stop_trace()
    ack.update(ok=bool(started), ms=ms, capture=out if started else None,
               trace=profiler.last_trace() if started else None)
    if not started:
        ack["error"] = "profiler capture unavailable (no-op)"
    metrics_registry.inc("tfos_health_captures_total", kind="profile",
                         status="ok" if started else "degraded")


def _flight(d, ack):
    from tensorflowonspark_tpu_torch.obs import flight

    path = flight.snapshot("health/on_demand", node=ack["node_id"],
                           reason=d.get("reason") or "on-demand")
    ack.update(ok=path is not None, capture=path)
    if path is None:
        ack["error"] = "telemetry disabled: no flight ring"
    metrics_registry.inc("tfos_health_captures_total", kind="flight",
                         status="ok" if path else "degraded")


_DIRECTIVES = {"profile": _profile, "flight": _flight}


def serve_control(mgr, node_id):
    """Take and run at most one directive for this node; returns the ack
    written back, or None when there was none."""
    try:
        d = mgr.obs_control_take(str(node_id))
    except Exception as e:  # noqa: BLE001 - the manager is gone
        logger.debug("obs control take failed for %s: %s", node_id, e)
        return None
    if not isinstance(d, dict):
        return None
    cmd = str(d.get("cmd", ""))
    ack = {"seq": d.get("seq"), "cmd": cmd, "node_id": str(node_id),
           "ts": time.time(), "ok": False}
    try:
        if cmd in _DIRECTIVES:
            _DIRECTIVES[cmd](d, ack)
        else:
            ack["error"] = f"unknown cmd {cmd!r}"
    except Exception as e:  # noqa: BLE001 - a directive always acks
        logger.warning("obs control %r failed on %s: %s", cmd, node_id, e)
        ack["error"] = str(e)[:200]
    try:
        mgr.obs_control_ack(str(node_id), ack)
    except Exception as e:  # noqa: BLE001 - the manager is gone
        logger.debug("obs control ack failed for %s: %s", node_id, e)
    return ack


def start_publisher(mgr, node_id, role=None, interval=None):
    """The publisher thread; returns its stop Event, or None when the
    metrics plane is off.  Setting the event publishes once more."""
    if not metrics_registry.enabled():
        return None
    period = (metrics_registry.interval() if interval is None
              else float(interval))
    stop = threading.Event()

    def _run():
        while not stop.wait(period):
            if not publish_once(mgr, node_id, role):
                return  # the manager is gone: the node is exiting
            serve_control(mgr, node_id)
        publish_once(mgr, node_id, role)

    threading.Thread(target=_run, name="tfos-obs-publish",
                     daemon=True).start()
    return stop
