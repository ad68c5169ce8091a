"""Workloads composed from the actor runtime (``actors/``) alone.

Own copies of ``tensorflowonspark_tpu/workloads``: the eval sidecar
(:class:`EvalSidecar`), the successive-halving sweep
(:func:`successive_halving`, :class:`TrialActor`) and the deploy loop
(:class:`DeployLoop`, :class:`PromotionController`,
:func:`run_deploy_loop`, :func:`deploy_table`).  Like the JAX modules
they carry no supervision, respawn or ledger code of their own: the
actor runtime supervises them, and ``ctx.ledger`` makes their effects
exactly-once (``tests/test_torch_workloads.py`` lints it).
"""

from tensorflowonspark_tpu_torch.workloads.deploy_loop import (  # noqa: F401
    DeployLoop,
    PromotionController,
    deploy_table,
    run_deploy_loop,
)
from tensorflowonspark_tpu_torch.workloads.eval_sidecar import (  # noqa: F401
    EvalSidecar,
)
from tensorflowonspark_tpu_torch.workloads.sweep import (  # noqa: F401
    TrialActor,
    successive_halving,
)
