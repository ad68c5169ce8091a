"""1 - device busy (union of kernels and copies) over the traced stretch, in %."""

from portbench.readers import idle_frac as _r


def read(run):
    return _r(run)
