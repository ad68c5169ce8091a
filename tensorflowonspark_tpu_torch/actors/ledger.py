"""Exactly-once delivery ledger.

An own copy of ``DeliveryLedger`` from
``tensorflowonspark_tpu/actors/ledger.py``: named done-sets
(``feed -> {partition}``), the table behind the rendezvous server's
PDONE/PQUERY messages.  Feeders record each partition once it was fully
consumed; the driver reads back which partitions were.
"""

from __future__ import annotations

import threading


class DeliveryLedger:
    """Named done-sets: ``record(feed, unit)`` / ``done_units(feed)``."""

    __slots__ = ("_lock", "_done")

    def __init__(self):
        self._lock = threading.Lock()
        self._done = {}

    def record(self, feed, unit):
        """Mark ``unit`` done for ``feed``; True iff newly recorded."""
        with self._lock:
            units = self._done.setdefault(str(feed), set())
            if unit in units:
                return False
            units.add(unit)
            return True

    def done(self, feed, unit):
        with self._lock:
            return unit in self._done.get(str(feed), ())

    def done_units(self, feed):
        """Sorted units recorded done for ``feed``."""
        with self._lock:
            return sorted(self._done.get(str(feed), ()))

    def reset(self, feed):
        """Forget ``feed``'s done-set (each ``train()`` owns one scope)."""
        with self._lock:
            self._done.pop(str(feed), None)
