"""Model FLOPs of the window's steps over the window at the bf16 peak, in %."""

from portbench.readers import mfu as _r


def read(run):
    return _r(run)
