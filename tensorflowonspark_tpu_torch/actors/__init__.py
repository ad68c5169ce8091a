"""Supervision primitives of the port: own copies of the part of
``tensorflowonspark_tpu/actors`` that the rendezvous and the engine
call (``DeliveryLedger``, ``reap_orphans``)."""

from tensorflowonspark_tpu_torch.actors.ledger import (  # noqa: F401
    DeliveryLedger,
)
from tensorflowonspark_tpu_torch.actors.supervise import (  # noqa: F401
    reap_orphans,
)
