"""Median device ms of the step's optimizer phase from the warm steps on."""

from portbench.spans import phase_ms


def read(run):
    return phase_ms(run, "optimizer")
