"""Online serving tier of the port (counterpart of
``tensorflowonspark_tpu/serving``).

Pieces:
  - :mod:`~.batcher` — dynamic micro-batching into padded power-of-two
    shape buckets;
  - :mod:`~.replicas` — supervised model replicas on the engine, with
    least-loaded dispatch, failover and checkpoint hot reload;
  - :mod:`~.server` — in-process Client, stdlib HTTP endpoint, SLO
    stats, the ``tfos-serve-torch`` CLI;
  - :mod:`~.decode` — continuous-batching autoregressive decode (paged
    KV cache, iteration-level scheduler, open-loop load generator);
  - :mod:`~.elastic` — the pool that degrades by resize and re-grows
    from the survivors' live params;
  - :mod:`~.fabric` — cross-host dispatch, session-affinity routing and
    the worker autoscaler.
"""

from tensorflowonspark_tpu_torch.serving.batcher import (  # noqa: F401
    MicroBatcher,
    Overloaded,
    bucket_seq,
    bucket_size,
    pad_columns,
    pad_rows,
    pad_seq,
)
from tensorflowonspark_tpu_torch.serving.decode import (  # noqa: F401
    DecodeEngine,
    DecodeSpec,
    PendingSession,
    run_open_loop,
)
from tensorflowonspark_tpu_torch.serving.replicas import (  # noqa: F401
    ModelSpec,
    ReplicaPool,
)
from tensorflowonspark_tpu_torch.serving.server import (  # noqa: F401
    Client,
    DecodeStats,
    Server,
    SLOStats,
    serve_http,
)
