"""Workloads composed from the actor runtime (``actors/``) alone.

Own copies of ``tensorflowonspark_tpu/workloads``: the eval sidecar
(:class:`EvalSidecar`) and the successive-halving sweep
(:func:`successive_halving`, :class:`TrialActor`).  Like the JAX
modules they carry no supervision, respawn or ledger code of their own:
the actor runtime supervises them, and ``ctx.ledger`` makes their
effects exactly-once (``tests/test_torch_workloads.py`` lints it).

The deploy loop (``DeployLoop``, ``PromotionController``,
``deploy_table``, ``run_deploy_loop``) drives the serving pool's canary
routing, which the port does not carry yet: each name raises
NotImplementedError naming its ROADMAP.md item.
"""

from tensorflowonspark_tpu_torch.workloads.eval_sidecar import (  # noqa: F401
    EvalSidecar,
)
from tensorflowonspark_tpu_torch.workloads.sweep import (  # noqa: F401
    TrialActor,
    successive_halving,
)

DEPLOY_ITEM = ("ROADMAP.md queue 1, item 25 (the deploy loop, with canary "
               "routing and the version watermark)")


def _no_deploy_loop(*args, **kwargs):
    raise NotImplementedError(f"the deploy loop comes with {DEPLOY_ITEM}")


DeployLoop = PromotionController = deploy_table = run_deploy_loop = \
    _no_deploy_loop
