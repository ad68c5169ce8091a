"""The blessed-checkpoint deploy loop: eval gate, canary, verdict.

An own copy of ``tensorflowonspark_tpu/workloads/deploy_loop.py``.  The
trainer writes checkpoints, the :class:`EvalSidecar` scores each step
once, a supervised :class:`PromotionController` actor blesses the steps
that pass its gate (the integrity manifest, per-file sha256, step and
eval score: ``utils/checkpoint.bless_checkpoint``) or tombstones them,
and the driver's :class:`DeployLoop` stages the rollout on a live
:class:`~tensorflowonspark_tpu_torch.serving.replicas.ReplicaPool`:

1. canary: pin an arm of replicas at the candidate and route
   ``TFOS_DEPLOY_CANARY_PCT``% of traffic there (the crc32 split,
   ``replicas.canary_arm``);
2. burn: gather each arm's outcomes for ``TFOS_DEPLOY_BURN_SECS``, which
   the pool exports as a registry snapshot (``canary_snapshot``), so the
   verdict runs the live metrics plane's math (``obs/slo.evaluate``);
3. verdict: promote (reload the baseline at the candidate, advance the
   watermark) or roll back (re-pin the arm at the last blessed step,
   tombstone the candidate, a flight dump and a ``deploy/rollback``
   event).

Like every workload it carries no supervision code (the lint test in
``tests/test_torch_workloads.py`` holds it to that): the controller
rides the actor runtime, the pool owns the replicas, and the driver's
pump is a plain synchronous function.  The manifests are the durable
state: blessed, untombstoned steps above the watermark are the queue,
so a restarted driver recovers by reading them (``recover()``), and a
controller's new incarnation re-gates nothing (the KV ledger and the
manifest's existence).

Chaos: the ``deploy.canary``, ``deploy.promote`` and ``deploy.rollback``
fault sites fire before their pool transition, so an injected fault
leaves the state machine as it was and the next pump retries
(:func:`run_deploy_loop` absorbs the raise).
"""

from __future__ import annotations

import logging
import math
import os
import time
import weakref

from tensorflowonspark_tpu_torch.actors import Actor
from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)

#: Live loops, for /statusz introspection (obs/http deploy rows).
_LOOPS = weakref.WeakSet()

GATE_LEDGER = "deploy_gate"

PCT_ENV = "TFOS_DEPLOY_CANARY_PCT"
ARM_ENV = "TFOS_DEPLOY_CANARY_REPLICAS"
BURN_ENV = "TFOS_DEPLOY_BURN_SECS"
MIN_SAMPLES_ENV = "TFOS_DEPLOY_MIN_SAMPLES"
EVAL_TOL_ENV = "TFOS_DEPLOY_EVAL_TOL"
LAT_TOL_ENV = "TFOS_DEPLOY_LAT_TOL"
SLO_ENV = "TFOS_DEPLOY_SLO"
GATE_MAX_ENV = "TFOS_DEPLOY_GATE_MAX"

#: Default burn-window objective: 99% of canary-arm requests must not
#: error.  Same grammar as TFOS_SLO (obs/slo.py); latency is judged
#: RELATIVELY (canary p95 vs baseline p95, ``TFOS_DEPLOY_LAT_TOL``)
#: because an absolute threshold is workload-specific.
DEFAULT_SLO = "deploy_availability:availability:tfos_deploy_requests_total@99"


def _env_float(name, default):
    raw = os.environ.get(name)
    return default if raw in (None, "") else float(raw)


class PromotionController(Actor):
    """Supervised gatekeeper: blesses or quarantines each checkpoint
    step once its eval result is in.

    Runs in the same :class:`~tensorflowonspark_tpu_torch.actors.ActorSystem`
    as the :class:`EvalSidecar` (it reads the sidecar's published
    ``eval_result:<step>`` through the shared manager KV).  Gate
    decisions are exactly-once across SIGKILL respawns: the KV ledger
    records judged steps, and a manifest already on disk short-circuits
    a re-judge (bless/tombstone are idempotent, so the at-least-once
    window between effect and record converges).

    ``gate_fn(metrics) -> bool`` overrides the default gate (score
    finite, and ``<= TFOS_DEPLOY_GATE_MAX`` when set).  Messages:

    - ``ask("latest")`` -> last gate decision or None
    - ``ask("judged")`` -> sorted steps already gated
    """

    def __init__(self, ckpt_dir, eval_group="eval", gate_fn=None,
                 score_key="loss"):
        self.ckpt_dir = ckpt_dir
        self.eval_group = eval_group
        self.gate_fn = gate_fn
        self.score_key = score_key
        self.last = None

    def _gate(self, metrics):
        score = metrics.get(self.score_key)
        score = None if score is None else float(score)
        if self.gate_fn is not None:
            return bool(self.gate_fn(metrics)), score, "gate_fn"
        if score is None or not math.isfinite(score):
            return False, score, f"{self.score_key}={score} not finite"
        gate_max = os.environ.get(GATE_MAX_ENV)
        if gate_max not in (None, "") and score > float(gate_max):
            return False, score, (f"{self.score_key}={score:g} over "
                                  f"gate max {float(gate_max):g}")
        return True, score, "pass"

    def on_tick(self, ctx):
        from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

        try:
            step, _path = ckpt.latest(self.ckpt_dir)
        except Exception:  # noqa: BLE001 - transient fs error
            return
        if step is None or ctx.ledger.done(GATE_LEDGER, step):
            return
        if ckpt.read_manifest(self.ckpt_dir, step) is not None:
            # a prior incarnation judged it between effect and record
            ctx.ledger.record(GATE_LEDGER, step)
            return
        result = ctx.mgr.get(
            f"actor_kv:{self.eval_group}:eval_result:{step}")
        if result is None:
            return  # the sidecar hasn't scored this step yet
        metrics = dict(result.get("metrics") or {})
        ok, score, why = self._gate(metrics)
        if ok:
            ckpt.bless_checkpoint(self.ckpt_dir, step, score=score,
                                  eval_metrics=metrics)
        else:
            ckpt.tombstone_checkpoint(self.ckpt_dir, step,
                                      reason=f"eval gate: {why}")
        ctx.ledger.record(GATE_LEDGER, step)
        self.last = {"step": step, "blessed": ok, "score": score,
                     "why": why}
        ctx.kv_set(f"deploy_gate:{step}", self.last)
        ctx.emit("deploy/gate", self.last)
        logger.info("promotion gate: step %d %s (%s)", step,
                    "blessed" if ok else "quarantined", why)

    def on_message(self, ctx, kind, payload):
        if kind == "latest":
            return self.last
        if kind == "judged":
            return ctx.ledger.done_units(GATE_LEDGER)
        raise NotImplementedError(f"unhandled message kind {kind!r}")


class DeployLoop:
    """Driver-side staged-rollout state machine over one pool + one
    checkpoint dir.  Synchronous by design: ``pump()`` attempts at most
    one transition and returns a status row; the caller owns cadence
    (:func:`run_deploy_loop` is the batteries-included driver).

    States: ``idle`` (scanning for a blessed candidate above the
    watermark) -> ``burn`` (canary open, evidence accumulating) ->
    back to ``idle`` via promote or rollback.
    """

    def __init__(self, pool, ckpt_dir, pct=None, canary_count=None,
                 burn_secs=None, min_samples=None, eval_tol=None,
                 lat_tol=None, slo_spec=None):
        from tensorflowonspark_tpu_torch.obs import slo as _slo

        self.pool = pool
        self.ckpt_dir = ckpt_dir
        self.pct = _env_float(PCT_ENV, 10.0) if pct is None else float(pct)
        self.canary_count = int(_env_float(ARM_ENV, 1)
                                if canary_count is None else canary_count)
        self.burn_secs = (_env_float(BURN_ENV, 30.0)
                          if burn_secs is None else float(burn_secs))
        self.min_samples = int(_env_float(MIN_SAMPLES_ENV, 10)
                               if min_samples is None else min_samples)
        self.eval_tol = (_env_float(EVAL_TOL_ENV, 0.1)
                         if eval_tol is None else float(eval_tol))
        self.lat_tol = (_env_float(LAT_TOL_ENV, 0.5)
                        if lat_tol is None else float(lat_tol))
        if slo_spec is None:
            slo_spec = os.environ.get(SLO_ENV, DEFAULT_SLO)
        self.objectives = _slo.parse_spec(slo_spec)
        self.state = "idle"
        self.candidate = None
        self.promotions = 0
        self.rollbacks = 0
        self.last_verdict = None
        self.history = []
        self._burn_deadline = None
        _LOOPS.add(self)

    # -- candidate discovery --------------------------------------------------
    def recover(self):
        """Re-pin the pool from durable state: the newest VERIFYING
        blessed manifest.  A fresh loop (or a restarted driver) calls
        this before pumping so rollout decisions always have a blessed
        baseline to fall back to."""
        from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

        if self.pool.watermark() is not None:
            return self.pool.watermark()
        step, _path = ckpt.latest_blessed(self.ckpt_dir)
        if step is not None:
            self.pool.pin_version(step)
            logger.info("deploy loop: recovered watermark at step %d", step)
        return step

    def _next_candidate(self):
        from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

        wm = self.pool.watermark()
        steps = [s for s in ckpt.blessed_steps(self.ckpt_dir)
                 if wm is None or s > wm]
        if not steps:
            return None
        cand = max(steps)  # newest blessed wins; stale siblings skipped
        ok, reason = ckpt.verify_manifest(self.ckpt_dir, cand)
        if not ok:
            logger.warning("deploy loop: candidate %d fails verify (%s); "
                           "skipped", cand, reason)
            return None
        return cand

    def _pick_arm(self):
        live = sorted(self.pool.live_replicas())
        count = max(1, min(self.canary_count, len(live) - 1))
        return live[:count]

    # -- the pump -------------------------------------------------------------
    def pump(self, now=None):
        """One synchronous transition attempt.  Raises on injected
        faults (state unchanged — the next pump retries); returns a
        status row either way on the normal path."""
        now = time.monotonic() if now is None else now
        if self.state == "idle":
            cand = self._next_candidate()
            if cand is not None:
                if self.pool.watermark() is None:
                    self._bootstrap(cand)
                else:
                    self._open_canary(cand, now)
        elif self.state == "burn" and now >= self._burn_deadline:
            ok, reasons = self._judge()
            if ok:
                self._promote()
            else:
                self._rollback(reasons)
        return self.status()

    def _bootstrap(self, step):
        """First blessed checkpoint: nothing to canary against, so the
        whole pool pins to it (still a promote commit — the fault site
        and the telemetry say so)."""
        faults.check("deploy.promote", step=step, bootstrap=True)
        self.pool.pin_version(step)
        self.promotions += 1
        self.last_verdict = {"step": step, "verdict": "promote",
                             "reasons": ["bootstrap"]}
        self.history.append(self.last_verdict)
        metrics_registry.inc("tfos_deploy_promotions_total")
        telemetry.event(telemetry.DEPLOY_PROMOTE, step=step,
                        bootstrap=True)
        logger.info("deploy loop: bootstrap promote to step %d", step)

    def _open_canary(self, cand, now):
        faults.check("deploy.canary", step=cand)
        arm = self._pick_arm()
        self.pool.set_canary(arm, cand, self.pct)
        self.candidate = cand
        self._burn_deadline = now + self.burn_secs
        self.state = "burn"

    def _promote(self):
        faults.check("deploy.promote", step=self.candidate)
        step = self.pool.promote_canary()
        self.promotions += 1
        self.last_verdict = {"step": step, "verdict": "promote",
                             "reasons": []}
        self.history.append(self.last_verdict)
        self.state, self.candidate = "idle", None
        metrics_registry.inc("tfos_deploy_promotions_total")
        telemetry.event(telemetry.DEPLOY_PROMOTE, step=step)
        logger.info("deploy loop: promoted step %d", step)

    def _rollback(self, reasons):
        from tensorflowonspark_tpu_torch.obs import flight
        from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

        cand = self.candidate
        faults.check("deploy.rollback", step=cand)
        target = self.pool.rollback_canary()
        ckpt.tombstone_checkpoint(self.ckpt_dir, cand,
                                  reason="; ".join(reasons) or "rollback")
        # the last telemetry window around the regression, preserved
        # before traffic converges back to baseline
        flight.snapshot(telemetry.DEPLOY_ROLLBACK,
                        node=f"deploy:{os.path.basename(self.ckpt_dir)}",
                        reason="; ".join(reasons))
        self.rollbacks += 1
        self.last_verdict = {"step": cand, "verdict": "rollback",
                             "target": target, "reasons": list(reasons)}
        self.history.append(self.last_verdict)
        self.state, self.candidate = "idle", None
        metrics_registry.inc("tfos_deploy_rollbacks_total")
        telemetry.event(telemetry.DEPLOY_ROLLBACK, step=cand,
                        target=target, reasons=list(reasons))
        logger.warning("deploy loop: rolled back step %s to %s (%s)",
                       cand, target, "; ".join(reasons))

    # -- the verdict ----------------------------------------------------------
    def _judge(self):
        """Burn-window verdict: (ok, reasons).  Fail-safe — a canary
        that produced no judgeable evidence does not promote."""
        from tensorflowonspark_tpu_torch.obs import slo as _slo
        from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

        reasons = []
        snap = self.pool.canary_snapshot()
        stats = self.pool.canary_stats()
        can, base = stats.get("canary"), stats.get("baseline")
        if not can or can["n"] < self.min_samples:
            n = can["n"] if can else 0
            reasons.append(f"insufficient canary traffic "
                           f"({n}/{self.min_samples})")
        # eval-score regression vs the blessed baseline (lower = better;
        # the manifests are the durable record of both scores)
        cand_man = ckpt.read_manifest(self.ckpt_dir, self.candidate) or {}
        base_man = (ckpt.read_manifest(self.ckpt_dir,
                                       self.pool.watermark() or -1) or {})
        c_score, b_score = cand_man.get("score"), base_man.get("score")
        if c_score is not None and not math.isfinite(float(c_score)):
            reasons.append(f"candidate eval score {c_score} not finite")
        elif (c_score is not None and b_score is not None
                and float(c_score) > float(b_score) * (1 + self.eval_tol)
                + 1e-12):
            reasons.append(f"eval regression: {float(c_score):g} vs "
                           f"blessed {float(b_score):g} "
                           f"(tol {self.eval_tol:g})")
        # SLO objectives per arm: the canary must not breach an
        # objective the baseline holds
        for obj in self.objectives:
            c_row = _slo.evaluate(obj, [_arm_view(snap, "canary")])
            b_row = _slo.evaluate(obj, [_arm_view(snap, "baseline")])
            if c_row["breaching"] and not b_row["breaching"]:
                reasons.append(
                    f"slo {obj.name}: canary burn {c_row['burn']} "
                    f"(baseline {b_row['burn']})")
        # relative latency guard: canary p95 within lat_tol of baseline
        if (can and base and can.get("p95_ms") is not None
                and base.get("p95_ms") and base["p95_ms"] > 0
                and can["p95_ms"] > base["p95_ms"] * (1 + self.lat_tol)):
            reasons.append(f"latency regression: canary p95 "
                           f"{can['p95_ms']:.1f}ms vs baseline "
                           f"{base['p95_ms']:.1f}ms (tol {self.lat_tol:g})")
        return not reasons, reasons

    # -- introspection --------------------------------------------------------
    def status(self):
        """One ``/statusz`` row (see :func:`deploy_table`)."""
        row = {
            "ckpt_dir": self.ckpt_dir,
            "state": self.state,
            "watermark": self.pool.watermark(),
            "candidate": self.candidate,
            "canary": self.pool.canary(),
            "stats": self.pool.canary_stats(),
            "promotions": self.promotions,
            "rollbacks": self.rollbacks,
            "last_verdict": self.last_verdict,
        }
        if self.state == "burn" and self._burn_deadline is not None:
            row["burn_remaining_s"] = round(
                max(0.0, self._burn_deadline - time.monotonic()), 1)
        return row

    def summary(self):
        return {
            "watermark": self.pool.watermark(),
            "promotions": self.promotions,
            "rollbacks": self.rollbacks,
            "history": list(self.history),
        }


def _arm_view(snap, arm):
    """Filter a registry-shaped snapshot down to one arm's series (the
    per-arm input ``obs/slo.evaluate`` judges — its merge helpers do not
    filter by label themselves)."""
    out = {}
    for name, ent in (snap or {}).items():
        series = [s for s in ent.get("series", ())
                  if s.get("labels", {}).get("arm") == arm]
        if series:
            out[name] = {"series": series}
    return out


def run_deploy_loop(pool, ckpt_dir, eval_fn, duration=60.0, poll_secs=0.5,
                    system=None, policy=None, env=None, eval_group="eval",
                    controller_group="deploy", gate_fn=None,
                    score_key="loss", stop_when=None, **knobs):
    """Drive the full loop for ``duration`` seconds: spawn the eval
    sidecar + promotion controller (into ``system``, or an own
    2-slot :class:`~tensorflowonspark_tpu_torch.actors.ActorSystem`),
    recover
    the watermark, then pump synchronously.

    Injected deploy-site faults and transient pump errors are absorbed
    (logged, retried next pump) — the chaos contract.  ``stop_when``
    (``loop -> bool``) ends the run early.  Returns
    :meth:`DeployLoop.summary`.
    """
    from tensorflowonspark_tpu_torch.workloads.eval_sidecar import (
        EvalSidecar,
    )

    own_system = system is None
    if own_system:
        from tensorflowonspark_tpu_torch.actors import ActorSystem

        system = ActorSystem(2, env=env)
    try:
        system.spawn(EvalSidecar(ckpt_dir, eval_fn), eval_group,
                     policy=policy)
        system.spawn(
            PromotionController(ckpt_dir, eval_group=eval_group,
                                gate_fn=gate_fn, score_key=score_key),
            controller_group, policy=policy)
        loop = DeployLoop(pool, ckpt_dir, **knobs)
        loop.recover()
        deadline = time.monotonic() + duration
        while time.monotonic() < deadline:
            try:
                loop.pump()
            except faults.FaultInjected as e:
                logger.warning("deploy loop: injected fault (%s); "
                               "retrying next pump", e)
            except Exception:  # noqa: BLE001 - transient (pool
                # resizing, manager hiccup): the loop must outlive it
                logger.exception("deploy loop: pump failed; retrying")
            if stop_when is not None and stop_when(loop):
                break
            time.sleep(poll_secs)
        return loop.summary()
    finally:
        if own_system:
            system.stop()


def deploy_table():
    """Status rows for every live :class:`DeployLoop` (the ``/statusz``
    deploy section and the ``tfos-top`` health pane)."""
    rows = []
    for loop in list(_LOOPS):
        try:
            rows.append(loop.status())
        except Exception:  # noqa: BLE001 - pool tearing down
            continue
    return sorted(rows, key=lambda r: r["ckpt_dir"])
