"""Checkpoint-watching evaluation as an actor.

An own copy of ``tensorflowonspark_tpu/workloads/eval_sidecar.py``.
Every idle tick the sidecar polls ``checkpoint.latest`` on its
``ckpt_dir``.  A step the ledger does not hold is restored
(``checkpoint.restore_any``), run through the caller's ``eval_fn``,
recorded in the ledger, published in the manager KV
(``eval_result:<step>``) and emitted as an ``eval/result`` event, with
an ``eval/run`` span and the ``tfos_eval_*`` metrics.  The ledger lives
in the driver's KV, so an incarnation respawned after a SIGKILL skips
what its predecessor recorded: each checkpoint step is evaluated once.

``eval_fn`` runs in the sidecar's executor, off the training path; it
may use the card (an actor system of its own then, whose executors
fork no trainer).  As everywhere in the port it travels by plain
pickle: a module-level function.
"""

from __future__ import annotations

import logging
import time

from tensorflowonspark_tpu_torch.actors import Actor
from tensorflowonspark_tpu_torch.utils import metrics_registry, telemetry

logger = logging.getLogger(__name__)

LEDGER_FEED = "eval"


class EvalSidecar(Actor):
    """Watches ``ckpt_dir`` and evaluates each new checkpoint step once.

    ``eval_fn(tree, step) -> dict`` gets the restored tree (host
    arrays).  Messages:

    - ``ask("latest")`` -> ``{"step": int, "metrics": dict}`` or None
    - ``ask("evaluated")`` -> the steps recorded, sorted
    """

    def __init__(self, ckpt_dir, eval_fn):
        self.ckpt_dir = ckpt_dir
        self.eval_fn = eval_fn
        self.last = None

    def on_tick(self, ctx):
        from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

        try:
            step, _path = ckpt.latest(self.ckpt_dir)
        except Exception:  # noqa: BLE001 - a transient listing error
            return
        if step is None or ctx.ledger.done(LEDGER_FEED, step):
            return
        tree, step = ckpt.restore_any(self.ckpt_dir)
        if tree is None:
            return
        t0 = time.perf_counter()
        results = self.eval_fn(tree, step)
        telemetry.record_span(telemetry.EVAL_RUN,
                              time.perf_counter() - t0, step=step)
        if not ctx.ledger.record(LEDGER_FEED, step):
            return  # a twin incarnation recorded it first; its result holds
        self.last = {"step": step, "metrics": results}
        ctx.kv_set(f"eval_result:{step}", self.last)
        ctx.emit("eval/result", self.last)
        metrics_registry.inc("tfos_eval_runs_total")
        metrics_registry.set_gauge("tfos_eval_last_step", step)
        logger.info("eval sidecar: step %d -> %s", step, results)

    def on_message(self, ctx, kind, payload):
        if kind == "latest":
            return self.last
        if kind == "evaluated":
            return ctx.ledger.done_units(LEDGER_FEED)
        raise NotImplementedError(f"unhandled message kind {kind!r}")
