"""Median device ms of the step's forward phase from the warm steps on."""

from portbench.spans import phase_ms


def read(run):
    return phase_ms(run, "forward")
