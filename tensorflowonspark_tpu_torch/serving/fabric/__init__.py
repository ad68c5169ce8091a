"""The serving fabric: cross-host replica dispatch, queue-driven worker
autoscaling, and session-affinity routing for the decode tier's paged
KV caches.  Own copies of ``tensorflowonspark_tpu/serving/fabric``:

  - :mod:`~.affinity`: the consistent-hash ring and the bounded LRU of
    route bindings (pure);
  - :mod:`~.host`: a host's engine task, N worker threads each with its
    own predictor and decode engine;
  - :mod:`~.router`: the driver's router (``Server(..., fabric=True)``
    mounts it): dispatch on ``actors.dispatch.InFlightTable``, SIGKILL
    failover, affinity routing, plan actuation;
  - :mod:`~.autoscale`: the supervised ``ServeAutoscaler`` actor over the
    router's queue-depth-a-worker signal.
"""

from tensorflowonspark_tpu_torch.serving.fabric.affinity import (  # noqa: F401
    AffinityMap,
    Ring,
)
from tensorflowonspark_tpu_torch.serving.fabric.autoscale import (  # noqa: F401
    ServeAutoscaler,
)
from tensorflowonspark_tpu_torch.serving.fabric.router import (  # noqa: F401
    FabricRouter,
    fabric_table,
    num_hosts_default,
)
