"""Typed mailboxes over the manager's queues: envelopes and
backpressure.

An own copy of ``tensorflowonspark_tpu/actors/mailbox.py``.  A manager
queue is a mailbox; this module names the envelope grammar, the queue
and KV key names, and the bounded send.  Envelopes are plain tuples
whose payloads are pickled (plain pickle, as the engine's tasks):

driver -> actor (one in-queue a member)::

    ("tell", epoch, kind, blob[, trace])          one way, no reply
    ("ask",  epoch, req_id, kind, blob[, trace])  reply on the out-queue
    ("stop",)                                     drain and exit

``trace`` is an optional W3C traceparent, so that the member's
``actor/message`` span joins the sender's trace.

actor -> driver (the group's shared out-queue)::

    ("up", idx, pid, epoch)               mailbox loop entered
    ("reply", idx, req_id, ok, blob)      an ask's answer (ok=False: traceback)
    ("event", idx, kind, blob)            unsolicited notification
    ("init_error", idx, repr)             on_start raised
    ("down", idx)                         clean exit

Epoch fencing: a member drops envelopes stamped older than its boot
epoch (the dead incarnation's inherited mail) and accepts current or
newer ones.  Replies resolve a resolve-once future by ``req_id``, so a
duplicate answer resolves once.
"""

from __future__ import annotations

__all__ = ["MailboxFull", "in_queue", "out_queue", "beat_key", "epoch_key",
           "checked_put"]


class MailboxFull(RuntimeError):
    """A bounded mailbox refused a send (backpressure, not an outage):
    carries the depth seen and the limit, so that callers can shed or
    retry."""

    def __init__(self, name, depth, limit):
        super().__init__(
            f"mailbox {name} is full ({depth} >= limit {limit}); "
            "receiver is not keeping up — retry later or raise "
            "TFOS_ACTOR_MAILBOX_DEPTH")
        self.name = name
        self.depth = depth
        self.limit = limit


def in_queue(group, idx):
    """Manager queue name of member ``idx``'s mailbox."""
    return f"actor_in:{group}:{idx}"


def out_queue(group):
    """Manager queue name of the group's shared driver-bound queue."""
    return f"actor_out:{group}"


def beat_key(group, idx):
    """Manager KV key member ``idx`` heartbeats under."""
    return f"actor_beat:{group}:{idx}"


def epoch_key(group, idx):
    """Manager KV key holding member ``idx``'s current epoch."""
    return f"actor_epoch:{group}:{idx}"


def checked_put(q, name, envelope, depth_limit):
    """Backpressured send: raises :class:`MailboxFull` instead of
    queueing past ``depth_limit``.  Returns the depth seen, plus one
    (the mailbox-depth gauge's sample)."""
    try:
        depth = q.qsize()
    except Exception:  # noqa: BLE001 - a proxy without qsize
        depth = 0
    if depth_limit and depth >= depth_limit:
        raise MailboxFull(name, depth, depth_limit)
    q.put(envelope)
    return depth + 1
