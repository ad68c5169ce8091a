"""Device-idle time inside the input waits over the traced stretch, in %."""

from portbench.spans import idle_wait_frac as _r


def read(run):
    return _r(run)
