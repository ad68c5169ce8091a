"""Median of the program's CUDA-event step times over the window's steps."""

from portbench.readers import device_step_ms as _r


def read(run):
    return _r(run)
