"""95th percentile (nearest rank) of every gap between a session's consecutive tokens as the client receives them, inside the window."""

from portbench.readers import itl_p95_ms as _r


def read(run):
    return _r(run)
