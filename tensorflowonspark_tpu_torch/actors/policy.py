"""Declarative supervision policy for actor classes.

An own copy of ``tensorflowonspark_tpu/actors/policy.py``: each actor
group declares its supervision as data (respawn budget, retry backoff,
heartbeat cadence and staleness, mailbox bound, idle tick, epoch
fencing) and ``actors.runtime`` enforces it.

The env family, with the older per-tier names as aliases:

=============================  =========================  =======
name                           alias                      default
=============================  =========================  =======
TFOS_ACTOR_HEARTBEAT_SECS      TFOS_HEARTBEAT_SECS        2
TFOS_ACTOR_HEARTBEAT_STALE     TFOS_HEARTBEAT_STALE       60
TFOS_ACTOR_RESPAWNS            TFOS_EXECUTOR_RESPAWNS     8
TFOS_ACTOR_RETRIES             TFOS_TASK_RETRIES          2
TFOS_ACTOR_BACKOFF             TFOS_RETRY_BACKOFF         0.25
TFOS_ACTOR_MAILBOX_DEPTH       —                          256
TFOS_ACTOR_TICK_SECS           —                          0.5
=============================  =========================  =======

The heartbeat pair resolves in ``manager.heartbeat_interval`` and
``manager.stale_after``, which every liveness consumer reads.
"""

from __future__ import annotations

import os

from tensorflowonspark_tpu_torch.manager import heartbeat_interval, stale_after

__all__ = ["SupervisionPolicy", "heartbeat_interval", "stale_after",
           "env_float", "env_int"]


def env_float(default, *names):
    """The first set env var among ``names`` as a float, else
    ``default``."""
    for name in names:
        raw = os.environ.get(name)
        if raw is not None and raw != "":
            return float(raw)
    return float(default)


def env_int(default, *names):
    """The first set env var among ``names`` as an int, else
    ``default``."""
    for name in names:
        raw = os.environ.get(name)
        if raw is not None and raw != "":
            return int(raw)
    return int(default)


class SupervisionPolicy:
    """How a group of actors is supervised.  Pickled into the actor
    task, so it stays plain data."""

    __slots__ = ("respawns", "retries", "backoff", "heartbeat_secs",
                 "stale_secs", "mailbox_depth", "tick_secs",
                 "epoch_fencing")

    def __init__(self, respawns=None, retries=None, backoff=None,
                 heartbeat_secs=None, stale_secs=None, mailbox_depth=None,
                 tick_secs=None, epoch_fencing=True):
        self.respawns = (env_int(8, "TFOS_ACTOR_RESPAWNS",
                                 "TFOS_EXECUTOR_RESPAWNS")
                         if respawns is None else int(respawns))
        self.retries = (env_int(2, "TFOS_ACTOR_RETRIES", "TFOS_TASK_RETRIES")
                        if retries is None else int(retries))
        self.backoff = (env_float(0.25, "TFOS_ACTOR_BACKOFF",
                                  "TFOS_RETRY_BACKOFF")
                        if backoff is None else float(backoff))
        self.heartbeat_secs = (heartbeat_interval() if heartbeat_secs is None
                               else float(heartbeat_secs))
        self.stale_secs = (stale_after() if stale_secs is None
                           else float(stale_secs))
        self.mailbox_depth = (env_int(256, "TFOS_ACTOR_MAILBOX_DEPTH")
                              if mailbox_depth is None
                              else int(mailbox_depth))
        self.tick_secs = (env_float(0.5, "TFOS_ACTOR_TICK_SECS")
                          if tick_secs is None else float(tick_secs))
        self.epoch_fencing = bool(epoch_fencing)

    def __getstate__(self):
        return {k: getattr(self, k) for k in self.__slots__}

    def __setstate__(self, state):
        for k, v in state.items():
            setattr(self, k, v)

    def __repr__(self):
        return ("SupervisionPolicy(" + ", ".join(
            f"{k}={getattr(self, k)!r}" for k in self.__slots__) + ")")
