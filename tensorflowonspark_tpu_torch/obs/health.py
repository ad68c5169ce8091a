"""Training-health watchtower: streaming anomaly detectors and reactions.

An own copy of ``tensorflowonspark_tpu/obs/health.py``.  A
``HealthMonitor`` rides the training loop's own numbers
(``utils.metrics.TrainMetrics.step`` hands it the step time, the infeed
stall fraction, the loss and, under ``TFOS_HEALTH_GRADNORM=1``, the
device-computed gradient norm of ``utils.train.health_probe``) and
edge-triggers four detectors:

- ``nan``: a loss or gradient norm that is not finite;
- ``loss_spike``: a loss above its EWMA mean by ``TFOS_HEALTH_SPIKE_SIGMA``
  EWMA standard deviations, after ``TFOS_HEALTH_WARMUP`` steps;
- ``slow_step``: ``TFOS_HEALTH_STEP_PATIENCE`` steps in a row slower
  than ``TFOS_HEALTH_STEP_FACTOR`` times the EWMA step time;
- ``infeed_stall``: the stall fraction at ``TFOS_HEALTH_STALL_FRAC`` or
  more.

A detector fires on the transition into its anomaly and re-arms when
the signal recovers.  A firing is a ``health/<kind>`` telemetry event, a
flight dump and the ``tfos_health_*`` metrics (which turn ``/healthz``
to ``degraded``).  ``TFOS_HEALTH_ACTION`` (``none``, ``checkpoint``,
``halt``) reacts to ``nan`` only: ``checkpoint`` calls the monitor's
``checkpoint_fn``, ``halt`` does and then raises :class:`HealthHalt`,
which the node turns into a clean stop.  ``TFOS_HEALTH=0`` builds no
monitor.

On the driver, :func:`straggler_report` compares the nodes' published
step-time histograms: the skew of the slowest median over the fastest
(``tfos_node_skew``, the ``/statusz`` stragglers table).  Stdlib only.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import weakref

from tensorflowonspark_tpu_torch.utils import metrics_registry, telemetry

logger = logging.getLogger(__name__)

ENABLE_ENV = "TFOS_HEALTH"
ACTION_ENV = "TFOS_HEALTH_ACTION"
GRADNORM_ENV = "TFOS_HEALTH_GRADNORM"
SPIKE_SIGMA_ENV = "TFOS_HEALTH_SPIKE_SIGMA"
WARMUP_ENV = "TFOS_HEALTH_WARMUP"
STEP_FACTOR_ENV = "TFOS_HEALTH_STEP_FACTOR"
STEP_PATIENCE_ENV = "TFOS_HEALTH_STEP_PATIENCE"
STALL_FRAC_ENV = "TFOS_HEALTH_STALL_FRAC"

ACTIONS = ("none", "checkpoint", "halt")
KINDS = ("nan", "loss_spike", "slow_step", "infeed_stall")
REACT_KINDS = ("nan",)  # spikes and stalls are advisory

_EWMA_ALPHA = 0.05  # ~20 steps of memory


def enabled():
    """The detectors run unless ``TFOS_HEALTH`` says 0 / false / off /
    no."""
    return os.environ.get(ENABLE_ENV, "1").strip().lower() not in (
        "0", "false", "off", "no")


def action_from_env():
    """The configured reaction; an unknown one warns and means none."""
    raw = os.environ.get(ACTION_ENV, "none").strip().lower() or "none"
    if raw not in ACTIONS:
        logger.warning("%s=%r not in %s; treating as 'none'", ACTION_ENV,
                       raw, ACTIONS)
        return "none"
    return raw


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        logger.warning("%s is not a number; using %s", name, default)
        return float(default)


class HealthHalt(RuntimeError):
    """Raised by a monitor whose reaction is ``halt``; the node stops
    cleanly on it."""


_MONITORS = weakref.WeakSet()  # this process's monitors
_MONITORS_LOCK = threading.Lock()
_LAST_STRAGGLERS = {}  # the driver's latest straggler report


class HealthMonitor:
    """Streaming detectors over one trainer's steps (see the module
    docstring); a detector without its signal stays quiet."""

    def __init__(self, action=None, checkpoint_fn=None, node=None):
        self.action = action_from_env() if action is None else str(action)
        if self.action not in ACTIONS:
            raise ValueError(f"action {self.action!r} not in {ACTIONS}")
        self.checkpoint_fn = checkpoint_fn
        self.node = node
        self.spike_sigma = _env_float(SPIKE_SIGMA_ENV, 6.0)
        self.warmup = int(_env_float(WARMUP_ENV, 20))
        self.step_factor = _env_float(STEP_FACTOR_ENV, 2.0)
        self.step_patience = int(_env_float(STEP_PATIENCE_ENV, 5))
        self.stall_frac = _env_float(STALL_FRAC_ENV, 0.5)
        self._loss_mean = None
        self._loss_var = 0.0
        self._loss_seen = 0
        self._time_mean = None
        self._time_seen = 0
        self._slow_run = 0       # slow steps in a row
        self._in_anomaly = {}    # kind -> anomalous now (the edge state)
        self.counts = {}         # kind -> firings
        self.last_anomaly = None
        self.last_finite_step = None
        with _MONITORS_LOCK:
            _MONITORS.add(self)

    def observe_step(self, loss=None, step_time_s=None, infeed_frac=None,
                     grad_norm=None, grad_finite=None, step=None):
        """One finished step's signals (host numbers: the caller pays
        any device read); returns the kinds that fired."""
        fired = self._observe_finite(loss, grad_norm, grad_finite, step)
        if loss is not None and math.isfinite(float(loss)):
            fired += self._observe_spike(float(loss), step)
        if grad_norm is not None and math.isfinite(float(grad_norm)):
            metrics_registry.set_gauge("tfos_health_grad_norm",
                                       float(grad_norm))
        if step_time_s is not None:
            fired += self._observe_step_time(float(step_time_s), step)
        if infeed_frac is not None:
            fired += self._observe_stall(float(infeed_frac), step)
        return fired

    def _observe_finite(self, loss, grad_norm, grad_finite, step):
        bad = []
        if loss is not None and not math.isfinite(float(loss)):
            bad.append(("loss", float(loss)))
        if grad_norm is not None and not math.isfinite(float(grad_norm)):
            bad.append(("grad_norm", float(grad_norm)))
        if grad_finite is not None and not bool(grad_finite):
            bad.append(("grad_finite", 0.0))
        if not bad:
            if loss is not None and step is not None:
                self.last_finite_step = step
            self._in_anomaly["nan"] = False
            return []
        source, value = bad[0]
        return self._fire("nan", step, source=source, value=str(value),
                          last_finite_step=self.last_finite_step)

    def _observe_spike(self, loss, step):
        mean, var, seen = self._loss_mean, self._loss_var, self._loss_seen
        fired = []
        if seen >= self.warmup and mean is not None:
            floor = 1e-3 * max(abs(mean), 1.0)  # a dead-flat loss
            threshold = mean + self.spike_sigma * max(
                math.sqrt(max(var, 0.0)), floor)
            if loss > threshold:
                fired = self._fire("loss_spike", step, loss=round(loss, 6),
                                   mean=round(mean, 6),
                                   threshold=round(threshold, 6))
            else:
                self._in_anomaly["loss_spike"] = False
        # the baseline moves after the test, spikes included, so a real
        # change of regime re-arms within ~1/alpha steps
        if mean is None:
            self._loss_mean, self._loss_var = loss, 0.0
        else:
            d = loss - mean
            self._loss_mean = mean + _EWMA_ALPHA * d
            self._loss_var = (1 - _EWMA_ALPHA) * (var + _EWMA_ALPHA * d * d)
        self._loss_seen = seen + 1
        return fired

    def _observe_step_time(self, dur_s, step):
        mean, seen = self._time_mean, self._time_seen
        fired = []
        if seen >= self.warmup and mean is not None and mean > 0:
            if dur_s > self.step_factor * mean:
                self._slow_run += 1
                if self._slow_run >= self.step_patience:
                    fired = self._fire(
                        "slow_step", step, step_ms=round(dur_s * 1000.0, 3),
                        baseline_ms=round(mean * 1000.0, 3),
                        consecutive=self._slow_run)
            else:
                self._slow_run = 0
                self._in_anomaly["slow_step"] = False
            # slow steps stay out of the baseline: a node stuck slow
            # keeps comparing against its healthy self
            if self._slow_run:
                return fired
        if mean is None:
            self._time_mean = dur_s
        else:
            self._time_mean = mean + _EWMA_ALPHA * (dur_s - mean)
        self._time_seen = seen + 1
        return fired

    def _observe_stall(self, frac, step):
        if self._loss_seen + self._time_seen < self.warmup:
            return []
        if frac >= self.stall_frac:
            return self._fire("infeed_stall", step,
                              stall_frac=round(frac, 4),
                              threshold=self.stall_frac)
        self._in_anomaly["infeed_stall"] = False
        return []

    def _fire(self, kind, step, **attrs):
        if self._in_anomaly.get(kind):
            return []
        self._in_anomaly[kind] = True
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.last_anomaly = dict(kind=kind, step=step, **attrs)
        logger.warning("health: %s anomaly at step %s (%s)", kind, step,
                       attrs)
        telemetry.event(f"health/{kind}", step=step, action=self.action,
                        **attrs)
        metrics_registry.inc("tfos_health_anomalies_total", kind=kind)
        metrics_registry.set_gauge("tfos_health_status", 1.0)
        if step is not None:
            metrics_registry.set_gauge("tfos_health_last_anomaly_step",
                                       float(step))
        try:  # the ring, while it still shows the approach
            from tensorflowonspark_tpu_torch.obs import flight

            flight.snapshot(f"health/{kind}", node=self.node,
                            reason=f"{kind} at step {step}")
        except Exception:  # noqa: BLE001 - dumps are best-effort
            logger.debug("flight snapshot failed", exc_info=True)
        self._react(kind, step)
        return [kind]

    def _react(self, kind, step):
        if self.action == "none" or kind not in REACT_KINDS:
            return
        if self.checkpoint_fn is not None:
            try:
                self.checkpoint_fn()
                logger.warning("health: checkpointed at last finite step "
                               "%s (action=%s)", self.last_finite_step,
                               self.action)
            except Exception:  # noqa: BLE001 - still halt if asked
                logger.exception("health: reaction checkpoint failed")
        if self.action == "halt":
            telemetry.flush()  # the event survives the stop
            raise HealthHalt(f"health: {kind} at step {step} (action=halt; "
                             f"last finite step {self.last_finite_step})")

    @property
    def status(self):
        return "degraded" if any(self._in_anomaly.values()) else "ok"

    def summary(self):
        return {"anomalies": dict(self.counts),
                "total": sum(self.counts.values()),
                "status": self.status, "last": self.last_anomaly}


def monitor_from_env(checkpoint_fn=None, node=None):
    """A monitor when the detectors are on, else None (what
    ``TrainMetrics`` builds by default)."""
    if not enabled():
        return None
    return HealthMonitor(checkpoint_fn=checkpoint_fn, node=node)


def process_summary():
    """Health over every monitor of this process, with the latest
    straggler report's skew."""
    anomalies, total, status = {}, 0, "ok"
    with _MONITORS_LOCK:
        monitors = list(_MONITORS)
    for m in monitors:
        for kind, n in m.counts.items():
            anomalies[kind] = anomalies.get(kind, 0) + n
            total += n
        if m.status == "degraded":
            status = "degraded"
    out = {"anomalies": anomalies, "total": total, "status": status,
           "max_skew": _LAST_STRAGGLERS.get("skew")}
    if _LAST_STRAGGLERS.get("slowest"):
        out["slowest_node"] = _LAST_STRAGGLERS["slowest"]
    return out


def _step_hist(snap, metric="tfos_train_step_ms"):
    for s in ((snap or {}).get(metric) or {}).get("series", ()):
        if "count" in s:
            return s
    return None


def straggler_report(node_entries, min_nodes=2, min_count=2, emit=True):
    """Cross-node step-time skew over ``{node_id: {"metrics": snapshot,
    ...}}``: ``{"skew", "slowest", "fastest", "nodes": [{node, p50_ms,
    steps, rel}, ...]}``, or None with fewer than ``min_nodes`` nodes of
    ``min_count`` steps.  ``emit`` sets ``tfos_node_skew`` and keeps the
    report for :func:`process_summary`."""
    rows = []
    for nid, ent in sorted((node_entries or {}).items()):
        h = _step_hist(ent.get("metrics"))
        if not h or h.get("count", 0) < min_count:
            continue
        p50 = metrics_registry.quantile(h, 0.5)
        if p50 is None or p50 <= 0:
            continue
        rows.append({"node": nid, "p50_ms": round(float(p50), 3),
                     "steps": int(h["count"])})
    if len(rows) < min_nodes:
        return None
    fastest = min(rows, key=lambda r: r["p50_ms"])
    slowest = max(rows, key=lambda r: r["p50_ms"])
    for r in rows:
        r["rel"] = round(r["p50_ms"] / fastest["p50_ms"], 3)
    skew = round(slowest["p50_ms"] / fastest["p50_ms"], 3)
    report = {"skew": skew, "slowest": slowest["node"],
              "fastest": fastest["node"], "nodes": rows}
    if emit:
        metrics_registry.set_gauge("tfos_node_skew", skew)
        _LAST_STRAGGLERS.clear()
        _LAST_STRAGGLERS.update(skew=skew, slowest=slowest["node"])
    return report


def snapshot_anomaly_total(snap):
    """The anomalies of every kind in one registry snapshot (the
    ``/healthz`` degraded test), or None when it reports none."""
    ent = (snap or {}).get("tfos_health_anomalies_total")
    if not ent:
        return None
    return sum(s.get("value", 0.0) for s in ent.get("series", ()))
