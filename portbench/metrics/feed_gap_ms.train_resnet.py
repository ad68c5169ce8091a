"""Median ms from a partition's drain end to the next one's first put."""

from portbench.spans import feed_gap_ms as _r


def read(run):
    return _r(run)
