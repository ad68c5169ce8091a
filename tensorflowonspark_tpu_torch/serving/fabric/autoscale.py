"""ServeAutoscaler: queue-driven worker autoscaling for the fabric.

An own copy of ``tensorflowonspark_tpu/serving/fabric/autoscale.py``.
The kernel is a hysteresis band: one action a cooldown window, a
high/low band the signal must clearly cross, and hard min/max clamps.

The signal is queueing, not utilisation: the router publishes each
host's ``{workers, depth}`` (``fabric:load``; depth = in-flight
envelopes of the dispatch table) and the kernel acts on ``total depth /
total workers``.  Above ``high`` it adds one worker to the emptiest host
(it spreads before it stacks); below ``low`` it retires one from the
fullest, where the host drops its highest-numbered worker first, so the
oldest workers and their warm KV caches survive a trough.

It runs as a supervised actor (``actors.runtime.Actor``): the instance
travels by plain pickle into an executor, connects to the router's
manager in ``on_start`` (``ctx.mgr`` is its ActorSystem's own), and
steps once a tick.  A respawned incarnation reseeds its plan sequence
from the KV, so its next plan supersedes the last.  Plans are only
published (``fabric:plan``); the router actuates them with
generation-fenced directives.

Knobs (env defaults): ``TFOS_SERVE_MIN_REPLICAS`` /
``TFOS_SERVE_MAX_REPLICAS`` clamp a host's workers;
``TFOS_SERVE_SCALE_HIGH`` / ``TFOS_SERVE_SCALE_LOW`` bound depth a
worker; ``TFOS_SERVE_SCALE_COOLDOWN`` spaces actions.
"""

from __future__ import annotations

import logging
import os
import time

from tensorflowonspark_tpu_torch.actors.runtime import Actor
from tensorflowonspark_tpu_torch.serving.fabric.host import LOAD_KEY, PLAN_KEY
from tensorflowonspark_tpu_torch.utils import telemetry

logger = logging.getLogger(__name__)

MIN_ENV = "TFOS_SERVE_MIN_REPLICAS"
MAX_ENV = "TFOS_SERVE_MAX_REPLICAS"
HIGH_ENV = "TFOS_SERVE_SCALE_HIGH"
LOW_ENV = "TFOS_SERVE_SCALE_LOW"
COOLDOWN_ENV = "TFOS_SERVE_SCALE_COOLDOWN"

SIGNAL_STALE_S = 10.0


def min_replicas_default():
    return int(os.environ.get(MIN_ENV, "1"))


def max_replicas_default():
    return int(os.environ.get(MAX_ENV, "4"))


class ServeAutoscaler(Actor):
    """Hysteresis kernel + actor plumbing.

    Two wirings share ``step()``:

    - **KV mode** (production): ``mgr_addr``/``mgr_authkey`` name the
      fabric router's manager; the kernel reads ``fabric:load`` and
      publishes ``fabric:plan``.
    - **Injected mode** (tests): ``read_signal()`` returns
      ``{host: {"workers", "depth"}}`` and ``apply_plan(plan)`` takes
      ``{host: workers}`` — the kernel is exercised without processes.
    """

    def __init__(self, mgr_addr=None, mgr_authkey=None, read_signal=None,
                 apply_plan=None, min_replicas=None, max_replicas=None,
                 high=None, low=None, cooldown=None):
        self._mgr_addr = tuple(mgr_addr) if mgr_addr else None
        self._mgr_authkey = mgr_authkey
        self._read_signal = read_signal
        self._apply_plan = apply_plan
        self.min_replicas = (min_replicas_default() if min_replicas is None
                             else int(min_replicas))
        self.max_replicas = (max_replicas_default() if max_replicas is None
                             else int(max_replicas))
        self.high = float(os.environ.get(HIGH_ENV, "2.0")
                          if high is None else high)
        self.low = float(os.environ.get(LOW_ENV, "0.25")
                         if low is None else low)
        self.cooldown = float(os.environ.get(COOLDOWN_ENV, "5.0")
                              if cooldown is None else cooldown)
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min ({self.min_replicas}) <= max "
                f"({self.max_replicas})")
        if not (0 <= self.low < self.high):
            raise ValueError(
                f"need 0 <= low ({self.low}) < high ({self.high})")
        self._mgr = None
        self._plan_seq = 0
        self._last_action = float("-inf")
        self.scale_ups = 0
        self.scale_downs = 0

    # A live manager proxy is not picklable; the actor reconnects in
    # on_start (and lazily, so a driver-side instance works too).
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_mgr"] = None
        return state

    def _connect(self):
        if self._mgr is None and self._mgr_addr is not None:
            from tensorflowonspark_tpu_torch import manager as tfmanager

            self._mgr = tfmanager.connect(self._mgr_addr, self._mgr_authkey)
            # reseed the sequence so a respawned incarnation's next plan
            # supersedes the one its predecessor published
            try:
                doc = self._mgr.get(PLAN_KEY)
                if isinstance(doc, dict):
                    self._plan_seq = int(doc.get("seq", 0))
            except Exception:  # noqa: BLE001 - empty KV on first boot
                pass
        return self._mgr

    def _read(self):
        """Normalized load signal: {int host: {"workers", "depth"}}."""
        if self._read_signal is not None:
            sig = self._read_signal()
        else:
            mgr = self._connect()
            if mgr is None:
                return None
            try:
                doc = mgr.get(LOAD_KEY)
            except Exception:  # noqa: BLE001 - router not publishing yet
                return None
            if not isinstance(doc, dict):
                return None
            if time.time() - float(doc.get("ts", 0)) > SIGNAL_STALE_S:
                return None  # stale rollup: the router stopped; sit still
            sig = doc.get("hosts")
        if not isinstance(sig, dict) or not sig:
            return None
        return {int(h): {"workers": int(v.get("workers", 0)),
                         "depth": int(v.get("depth", 0))}
                for h, v in sig.items()}

    def _apply(self, plan):
        if self._apply_plan is not None:
            self._apply_plan(dict(plan))
            return
        mgr = self._connect()
        if mgr is None:
            return
        self._plan_seq += 1
        mgr.set(PLAN_KEY, {"seq": self._plan_seq,
                           "hosts": {str(h): int(n)
                                     for h, n in plan.items()},
                           "ts": time.time()})

    def step(self, now=None):
        """One decision: "up", "down", or None (in cooldown, no signal,
        in band, or clamped)."""
        now = time.monotonic() if now is None else now
        if now - self._last_action < self.cooldown:
            return None
        sig = self._read()
        if not sig:
            return None
        workers = {h: max(0, v["workers"]) for h, v in sig.items()}
        total = sum(workers.values())
        if total <= 0:
            return None
        ratio = sum(v["depth"] for v in sig.values()) / total
        if ratio > self.high:
            cands = [h for h, n in workers.items() if n < self.max_replicas]
            if not cands:
                return None
            h = min(cands, key=lambda x: (workers[x], x))
            plan = dict(workers)
            plan[h] += 1
            self._apply(plan)
            self.scale_ups += 1
            self._last_action = now
            telemetry.event("serve/fabric_scale_up", host=h,
                            ratio=round(ratio, 3),
                            replicas=sum(plan.values()))
            logger.info("fabric scale-up: host %d -> %d workers "
                        "(depth/worker %.2f > %.2f)", h, plan[h], ratio,
                        self.high)
            return "up"
        if ratio < self.low:
            cands = [h for h, n in workers.items() if n > self.min_replicas]
            if not cands:
                return None
            h = max(cands, key=lambda x: (workers[x], x))
            plan = dict(workers)
            plan[h] -= 1
            self._apply(plan)
            self.scale_downs += 1
            self._last_action = now
            telemetry.event("serve/fabric_scale_down", host=h,
                            ratio=round(ratio, 3),
                            replicas=sum(plan.values()))
            logger.info("fabric scale-down: host %d -> %d workers "
                        "(depth/worker %.2f < %.2f)", h, plan[h], ratio,
                        self.low)
            return "down"
        return None

    # -- actor hooks -----------------------------------------------------------
    def on_start(self, ctx):
        self._connect()

    def on_tick(self, ctx):
        try:
            self.step()
        except Exception:  # noqa: BLE001 - next tick retries
            logger.exception("autoscaler step failed")

    def on_message(self, ctx, kind, payload):
        if kind == "step":
            return self.step()
        if kind == "status":
            return {"scale_ups": self.scale_ups,
                    "scale_downs": self.scale_downs,
                    "min": self.min_replicas, "max": self.max_replicas,
                    "high": self.high, "low": self.low,
                    "cooldown": self.cooldown}
        return None
