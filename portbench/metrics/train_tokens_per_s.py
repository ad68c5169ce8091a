"""Tokens of every training step in the window, over its seconds."""

from portbench.readers import train_rate as _r


def read(run):
    return _r(run, "tokens")
