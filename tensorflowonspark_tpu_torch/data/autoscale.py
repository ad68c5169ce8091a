"""Stall-driven data-worker autoscaling.

An own copy of ``tensorflowonspark_tpu/data/autoscale.py``.  The signal
is the trainers' feed-wait ratio: the share of wall time they spent
blocked on the input, from the ``tfos_feed_wait_seconds_total``
counters each trainer publishes through its manager's obs channel.
The control is a slow hysteresis loop: above ``high`` for one interval,
add a worker; below ``low``, retire one; a cooldown between actions.
Actuation is indirect:

- **scale up** calls ``scale_up(widx)``: the cluster launches one more
  dynamic worker task (``data.service.dynamic_serve_task``) and appends
  ``widx`` to the split board's plan, which re-deals the trainers'
  rings over the workers;
- **scale down** calls ``scale_down(widx)``: the cluster takes ``widx``
  out of the plan; the worker sees it, drains, records and exits.

The gauge ``tfos_data_workers`` tracks the active count; telemetry
events ``data/scale_up`` and ``data/scale_down`` mark the decisions.
"""

from __future__ import annotations

import logging
import threading
import time

from tensorflowonspark_tpu_torch.utils import metrics_registry, telemetry

logger = logging.getLogger(__name__)

MAX_WORKERS_ENV = "TFOS_DATA_MAX_WORKERS"


class StallAutoscaler:
    """Hysteresis controller over a stall-ratio signal (module
    docstring).  ``read_stall() -> float | None`` returns the feed-wait
    ratio over the last interval (None = no signal yet: do nothing).
    Runs its own daemon thread between :meth:`start` and :meth:`stop`;
    :meth:`step` is the pure decision kernel the tests drive directly.
    """

    def __init__(self, read_stall, scale_up, scale_down,
                 min_workers=1, max_workers=1, high=0.25, low=0.05,
                 interval=2.0, cooldown=10.0):
        if min_workers < 1 or max_workers < min_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{min_workers}/{max_workers}")
        if not 0.0 <= low < high:
            raise ValueError(f"need 0 <= low < high, got {low}/{high}")
        self.read_stall = read_stall
        self.scale_up = scale_up
        self.scale_down = scale_down
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.high = float(high)
        self.low = float(low)
        self.interval = float(interval)
        self.cooldown = float(cooldown)
        self.workers = self.min_workers   # current active count
        self._next_widx = self.min_workers
        self._retired = []                # widx stack for scale-down
        self._last_action = 0.0
        self._stop = threading.Event()
        self._thread = None

    # -- decision kernel ---------------------------------------------------

    def step(self, now=None):
        """One control decision; returns "up", "down" or None."""
        now = time.monotonic() if now is None else now
        if now - self._last_action < self.cooldown:
            return None
        stall = self.read_stall()
        if stall is None:
            return None
        if stall > self.high and self.workers < self.max_workers:
            widx = self._next_widx
            self._next_widx += 1
            self.scale_up(widx)
            self.workers += 1
            self._retired.append(widx)
            self._last_action = now
            metrics_registry.set_gauge("tfos_data_workers", self.workers)
            telemetry.event("data/scale_up", worker=widx,
                            workers=self.workers, stall=round(stall, 4))
            logger.info("data autoscaler: stall %.0f%% > %.0f%%, scaled "
                        "up to %d workers (+%d)", stall * 100,
                        self.high * 100, self.workers, widx)
            return "up"
        if stall < self.low and self.workers > self.min_workers:
            # retire the most recently added worker first: the baseline
            # workers were placed by the original dispatch plan
            widx = self._retired.pop()
            self.scale_down(widx)
            self.workers -= 1
            self._last_action = now
            metrics_registry.set_gauge("tfos_data_workers", self.workers)
            telemetry.event("data/scale_down", worker=widx,
                            workers=self.workers, stall=round(stall, 4))
            logger.info("data autoscaler: stall %.1f%% < %.0f%%, scaled "
                        "down to %d workers (-%d)", stall * 100,
                        self.low * 100, self.workers, widx)
            return "down"
        return None

    # -- thread ------------------------------------------------------------

    def start(self):
        metrics_registry.set_gauge("tfos_data_workers", self.workers)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="tfos-data-autoscaler", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.step()
            except Exception:  # noqa: BLE001 - scaling is best-effort
                logger.exception("data autoscaler: step failed")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def obs_stall_reader(snapshots_fn, counter="tfos_feed_wait_seconds_total"):
    """A ``read_stall`` over trainer obs snapshots: per call, the delta
    of the summed trainer feed-wait counters over the delta of wall
    time, normalized per trainer — i.e. the mean fraction of the last
    window each trainer spent waiting on input.  ``snapshots_fn()``
    returns the manager's ``obs_snapshots()`` dict (payloads as
    published by ``obs/publish.py``: {"role": ..., "metrics":
    {name: {"series": [{"value": v}, ...]}}}).
    """
    state = {"t": None, "total": None}

    def _sum_counters():
        total = 0.0
        trainers = 0
        for payload in snapshots_fn().values():
            if not isinstance(payload, dict):
                continue
            if payload.get("role") in ("data", "driver"):
                continue  # only trainer-side wait counts as ingest stall
            ent = (payload.get("metrics") or {}).get(counter)
            if not ent:
                continue
            total += sum(float(s.get("value") or 0.0)
                         for s in ent.get("series", ()))
            trainers += 1
        return total, trainers

    def _read():
        now = time.monotonic()
        try:
            total, trainers = _sum_counters()
        except Exception:  # noqa: BLE001 - manager momentarily unreachable
            return None
        prev_t, prev_total = state["t"], state["total"]
        state["t"], state["total"] = now, total
        if prev_t is None or trainers == 0:
            return None
        dt = now - prev_t
        if dt <= 0:
            return None
        return max(0.0, (total - prev_total) / dt / trainers)

    return _read
