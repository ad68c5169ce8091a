"""Supervision primitives of the port: own copies of the part of
``tensorflowonspark_tpu/actors`` that the rendezvous, the engine and the
serving tier call (the ledgers, the in-flight dispatch table, keyed
heartbeats, respawn budgets and retry schedules, orphan reaping)."""

from tensorflowonspark_tpu_torch.actors.dispatch import (  # noqa: F401
    InFlightTable,
)
from tensorflowonspark_tpu_torch.actors.ledger import (  # noqa: F401
    DeliveryLedger,
    IndexLedger,
    OnceGate,
    ResolveOnce,
)
from tensorflowonspark_tpu_torch.actors.supervise import (  # noqa: F401
    RespawnBudget,
    RetrySchedule,
    reap_orphans,
)
