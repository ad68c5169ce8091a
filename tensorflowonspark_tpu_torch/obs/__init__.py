"""The live observability plane: an own copy of ``tensorflowonspark_tpu/obs``.

- ``utils/metrics_registry.py``: each process's counters, gauges and
  histograms;
- ``obs/publish.py``: a node's publisher thread, which ships its
  registry into the manager's KV and serves ``/profilez`` and
  ``/flightz`` directives;
- ``obs/http.py``: the driver's ``ObsServer`` (``/metrics``,
  ``/healthz``, ``/statusz``, ``/slo``), which ``obs/top.py``
  (``tfos-top-torch``) renders;
- ``obs/health.py`` (the training-health watchtower), ``obs/slo.py``
  (objectives and burn), ``obs/flight.py`` (the flight recorder) and
  ``obs/postmortem.py`` (``tfos-postmortem-torch``).

With ``TFOS_OBS_PORT`` unset nothing here runs: no server, no thread, no
registry.  Stdlib only.
"""

from tensorflowonspark_tpu_torch.obs.http import (  # noqa: F401
    ObsServer,
    start_for_cluster,
)
from tensorflowonspark_tpu_torch.obs.publish import (  # noqa: F401
    start_publisher,
)
from tensorflowonspark_tpu_torch.utils.metrics_registry import (  # noqa: F401
    PORT_ENV,
    enabled,
)
