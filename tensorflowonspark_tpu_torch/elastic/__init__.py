"""Elastic runtime: virtual-device layouts with resize and reshard.

Counterpart of ``tensorflowonspark_tpu/elastic``.  It decouples the
logical mesh a model is configured for from the ranks an incarnation
happens to have (``virtual.py``), resolves a node's process group into
a layout (``runtime.py``), and re-places train state when the topology
changes under supervision (``reshard.py``).
"""

from tensorflowonspark_tpu_torch.elastic.reshard import (  # noqa: F401
    host_fetch,
    reshard,
    reshard_train_state,
)
from tensorflowonspark_tpu_torch.elastic.runtime import (  # noqa: F401
    ElasticRuntime,
    TrainSpec,
    from_context,
)
from tensorflowonspark_tpu_torch.elastic.virtual import (  # noqa: F401
    VirtualLayout,
    virtualize,
)
