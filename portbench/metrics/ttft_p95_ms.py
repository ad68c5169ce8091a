"""95th percentile (nearest rank) of time to first token from the client's submit, over every request whose first token came inside the window; a failed request counts as infinitely late."""

from portbench.readers import ttft_p95_ms as _r


def read(run):
    return _r(run)
