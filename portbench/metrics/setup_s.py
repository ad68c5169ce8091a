"""Process start to the window's start, on the host clock."""

from portbench.readers import setup_s as _r


def read(run):
    return _r(run)
