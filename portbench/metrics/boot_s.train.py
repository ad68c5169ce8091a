"""cluster.run's call to the trainer's first step (the program's report)."""

from portbench.readers import boot_s as _r


def read(run):
    return _r(run)
