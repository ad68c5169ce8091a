"""Orphan reaping.

An own copy of ``reap_orphans`` from
``tensorflowonspark_tpu/actors/supervise.py``, the one mechanism the
port's ``LocalEngine`` uses: its ``stop()`` kills every child an
executor recorded (IPC-manager server, background trainer) that is
still alive, so nothing outlives the engine.  Respawn budgets and task
retries come with ``restarts`` (ROADMAP.md).
"""

from __future__ import annotations

import logging

from tensorflowonspark_tpu_torch.utils import (
    clear_child_pids,
    kill_pid,
    read_child_pids,
)

logger = logging.getLogger(__name__)


def reap_orphans(dirs, what="child"):
    """Kill and forget every still-live pid recorded in the given
    executor working dirs; returns the pids killed."""
    killed = []
    for d in dirs:
        for pid in read_child_pids(d):
            if kill_pid(pid, 0):  # still alive
                logger.warning("reaping orphaned %s pid %d", what, pid)
                kill_pid(pid)
                killed.append(pid)
        clear_child_pids(d)
    return killed
