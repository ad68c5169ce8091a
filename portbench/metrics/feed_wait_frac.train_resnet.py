"""The feed's waits (feed/wait spans) inside the window, over it, in %."""

from portbench.readers import feed_wait_frac as _r


def read(run):
    return _r(run)
