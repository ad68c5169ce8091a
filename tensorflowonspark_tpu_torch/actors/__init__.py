"""Supervision primitives of the port: own copies of
``tensorflowonspark_tpu/actors`` (the ledgers, the in-flight dispatch
table, keyed heartbeats, respawn budgets and retry schedules, orphan
reaping, the mailbox grammar, the supervision policy and the actor
runtime that the data service's split provider runs on)."""

from tensorflowonspark_tpu_torch.actors.dispatch import (  # noqa: F401
    InFlightTable,
)
from tensorflowonspark_tpu_torch.actors.ledger import (  # noqa: F401
    DeliveryLedger,
    IndexLedger,
    KVLedger,
    NullLedgerClient,
    OnceGate,
    ResolveOnce,
    resume_cursor,
)
from tensorflowonspark_tpu_torch.actors.mailbox import (  # noqa: F401
    MailboxFull,
)
from tensorflowonspark_tpu_torch.actors.policy import (  # noqa: F401
    SupervisionPolicy,
)
from tensorflowonspark_tpu_torch.actors.supervise import (  # noqa: F401
    RespawnBudget,
    RetrySchedule,
    reap_orphans,
)
from tensorflowonspark_tpu_torch.actors.runtime import (  # noqa: F401
    Actor,
    ActorContext,
    ActorGroup,
    ActorSystem,
    AskFuture,
    EchoActor,
    actor_table,
)
