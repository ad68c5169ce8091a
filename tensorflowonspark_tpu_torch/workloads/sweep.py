"""A successive-halving hyperparameter sweep as actors.

An own copy of ``tensorflowonspark_tpu/workloads/sweep.py``.  Configs
compete in rungs: every survivor of a rung runs at the rung's budget,
the best ``ceil(n / eta)`` go on, and the budget grows by ``eta``
(successive halving, Hyperband's inner loop), so the whole sweep costs
about ``n * budget * log_eta(n)`` trial units.

Trials are ``ask``s to an :class:`~tensorflowonspark_tpu_torch.actors.
ActorGroup` of :class:`TrialActor`s, so a member SIGKILLed mid-trial is
respawned by the runtime and its trial sent again, and the ask's
resolve-once future absorbs a duplicate answer; the module holds no
supervision code of its own.  Each rung is a barrier: every surviving
config's answer arrives before the ranking, as ``parallel_run``'s
``collect`` waits for every instance.
"""

from __future__ import annotations

import logging
import math

from tensorflowonspark_tpu_torch.actors import Actor
from tensorflowonspark_tpu_torch.utils import telemetry

logger = logging.getLogger(__name__)


class TrialActor(Actor):
    """Runs one trial an ``ask``: ``trial_fn(config, budget) -> score``
    (higher is better).  It keeps no state between trials, so any
    member can run any trial."""

    def __init__(self, trial_fn):
        self.trial_fn = trial_fn

    def on_message(self, ctx, kind, payload):
        if kind != "trial":
            raise NotImplementedError(f"unhandled message kind {kind!r}")
        score = self.trial_fn(payload["config"], payload["budget"])
        return {"trial": payload["trial"], "score": float(score),
                "budget": payload["budget"]}


def successive_halving(trial_fn, configs, budget=1, eta=2, workers=None,
                       system=None, policy=None, env=None, target=None,
                       timeout=600.0, name="sweep"):
    """A successive-halving sweep over ``configs``.

    ``trial_fn(config, budget) -> score`` (higher is better) is a
    module-level function (members import it) that a re-sent trial may
    run twice.  ``budget`` is rung 0's, ``eta`` the halving rate: keep
    ``ceil(n / eta)`` a rung and multiply the budget by ``eta``.
    ``workers``: trial actors to spawn (default ``min(len(configs),
    4)``), into ``system`` (an ``ActorSystem``; default a new one on
    ``workers`` executors with ``env``, stopped at the end).  ``policy``:
    the trial group's ``SupervisionPolicy``.  ``target``: stop as soon as
    a rung's best reaches it.  ``timeout``: a rung's wait for every
    answer.  ``name``: the group's name.

    Returns ``{"best": {"trial", "config", "score", "budget"},
    "history": [{"rung", "budget", "scores": {trial: score}}, ...]}``.
    """
    configs = list(configs)
    if not configs:
        raise ValueError("successive_halving needs at least one config")
    workers = int(workers or min(len(configs), 4))
    own_system = system is None
    if own_system:
        from tensorflowonspark_tpu_torch.actors import ActorSystem

        system = ActorSystem(workers, env=env)
    try:
        group = system.spawn(TrialActor(trial_fn), name, count=workers,
                             policy=policy)
        survivors = list(enumerate(configs))  # (trial id, config)
        history = []
        best = None
        rung = 0
        while survivors:
            futures = [(tid, cfg,
                        group.ask("trial", {"trial": tid, "config": cfg,
                                            "budget": budget}))
                       for tid, cfg in survivors]
            # the rung's barrier: every survivor answers before the ranking
            results = [(tid, cfg, f.result(timeout))
                       for tid, cfg, f in futures]
            results.sort(key=lambda r: (-r[2]["score"], r[0]))
            history.append({
                "rung": rung, "budget": budget,
                "scores": {tid: r["score"] for tid, _cfg, r in results},
            })
            tid, cfg, r = results[0]
            best = {"trial": tid, "config": cfg, "score": r["score"],
                    "budget": budget}
            telemetry.event("sweep/rung", rung=rung, budget=budget,
                            survivors=len(results),
                            best_trial=tid, best_score=r["score"])
            if target is not None and best["score"] >= target:
                logger.info("sweep: target %.4g reached at rung %d by "
                            "trial %d", target, rung, tid)
                break
            if len(results) == 1:
                break
            keep = max(1, math.ceil(len(results) / eta))
            survivors = [(t, c) for t, c, _r in results[:keep]]
            budget *= eta
            rung += 1
        return {"best": best, "history": history}
    finally:
        if own_system:
            system.stop()
