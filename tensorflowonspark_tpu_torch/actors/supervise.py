"""Respawn budgets, retry schedules and orphan reaping.

Own copies of ``RespawnBudget``, ``RetrySchedule`` and ``reap_orphans``
from ``tensorflowonspark_tpu/actors/supervise.py``, the mechanisms
under the port's ``LocalEngine``: a retryable job's failed task is
re-dispatched after a jittered exponential backoff, and a dead executor
is respawned within a budget after its children are killed.  Its
``stop()`` kills every child an executor recorded (IPC-manager server,
background trainer) that is still alive, so nothing outlives the
engine.
"""

from __future__ import annotations

import logging
import random

from tensorflowonspark_tpu_torch.utils import (
    clear_child_pids,
    kill_pid,
    read_child_pids,
)

logger = logging.getLogger(__name__)

__all__ = ["BudgetExhausted", "RespawnBudget", "RetrySchedule",
           "reap_orphans"]


class BudgetExhausted(RuntimeError):
    """A supervised member died more times than its policy allows."""


class RespawnBudget:
    """Counted permission to replace dead members of a pool.

    ``consume(index)`` either counts one respawn or raises ``error_cls``
    naming the env knob, so the operator knows what to raise."""

    __slots__ = ("budget", "used", "what", "env_name", "error_cls")

    def __init__(self, budget, what="executor",
                 env_name="TFOS_ACTOR_RESPAWNS", error_cls=BudgetExhausted):
        self.budget = int(budget)
        self.used = 0
        self.what = what
        self.env_name = env_name
        self.error_cls = error_cls

    def consume(self, index):
        if self.used >= self.budget:
            raise self.error_cls(
                f"{self.what} {index} died and the respawn budget "
                f"({self.env_name}={self.budget}) is exhausted")
        self.used += 1
        return self.used


class RetrySchedule:
    """Per-key retry bookkeeping with jittered exponential backoff.
    Every failure reason is kept in arrival order, so the permanent
    error carries the whole attempt history."""

    __slots__ = ("max_retries", "backoff", "cap", "attempts", "failures")

    def __init__(self, max_retries, backoff, cap=5.0):
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.cap = float(cap)
        self.attempts = {}   # key -> retries consumed
        self.failures = {}   # key -> [reason], in order

    def record_failure(self, key, reason):
        self.failures.setdefault(key, []).append(reason)

    def exhausted(self, key):
        return self.attempts.get(key, 0) >= self.max_retries

    def next_delay(self, key):
        """Consume one retry; seconds to wait before re-dispatching
        (exponential in the attempt number, capped, jittered)."""
        a = self.attempts.get(key, 0) + 1
        self.attempts[key] = a
        delay = min(self.backoff * (2 ** (a - 1)), self.cap)
        return delay * (0.5 + random.random())

    def attempt(self, key):
        return self.attempts.get(key, 0)

    def permanent_error(self, key, subject):
        """The gave-up message: latest failure first, earlier attempts
        chained."""
        reasons = self.failures.get(key) or ["(no failure recorded)"]
        msg = f"{subject}:\n{reasons[-1]}"
        if len(reasons) > 1:
            chain = "\n--- earlier attempt ---\n".join(reasons[:-1])
            msg += (f"\n(permanent after {len(reasons)} attempts; "
                    f"earlier attempts:\n{chain})")
        return msg


def reap_orphans(dirs, what="child"):
    """Kill and forget every still-live pid recorded in the given
    executor working dirs; returns the pids killed.  A dead executor's
    children die before its replacement starts."""
    killed = []
    for d in dirs:
        for pid in read_child_pids(d):
            if kill_pid(pid, 0):  # still alive
                logger.warning("reaping orphaned %s pid %d", what, pid)
                kill_pid(pid)
                killed.append(pid)
        clear_child_pids(d)
    return killed
