"""Resolve-once futures and exactly-once delivery ledgers.

Own copies of the primitives of ``tensorflowonspark_tpu/actors/ledger.py``:

- :class:`OnceGate` — a claim that exactly one caller wins (the
  duplicate-answer guard of a re-dispatched batch, ``batcher.Batch``).
- :class:`ResolveOnce` — a thread-safe future whose first ``resolve`` /
  ``reject`` wins; later calls are no-ops (``batcher.PendingResult``,
  ``decode.scheduler.PendingSession``).
- :class:`IndexLedger` — first-arrival-wins values keyed by a dense
  index: a decode session's token stream, which a failover replay
  re-delivers as identical ``(index, token)`` pairs.
- :class:`DeliveryLedger` — named done-sets (``feed -> {partition}``),
  the table behind the rendezvous server's PDONE/PQUERY messages.
  :class:`KVLedger` is the same contract kept in a manager KV (one key a
  unit), so it outlives the recording process: an actor's respawn
  resumes past everything recorded.
- :class:`NullLedgerClient` and :func:`resume_cursor`: the data
  service's ledger stand-in when no rendezvous server answers, and the
  unit a respawned data worker resumes at.

Stdlib only: imported by executors, replicas and the driver alike.
"""

from __future__ import annotations

import threading
import time


class OnceGate:
    """First ``claim()`` returns True, every later one False."""

    __slots__ = ("_lock", "_claimed")

    def __init__(self):
        self._lock = threading.Lock()
        self._claimed = False

    def claim(self):
        with self._lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def claimed(self):
        with self._lock:
            return self._claimed


class ResolveOnce:
    """A thread-safe future: the first ``resolve``/``reject`` wins."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error = None

    def done(self):
        return self._event.is_set()

    def resolve(self, value):
        """Resolve with ``value``; True iff this call won the race."""
        if self._event.is_set():
            return False
        self._value = value
        self._event.set()
        return True

    def reject(self, exc):
        """Resolve exceptionally; True iff this call won the race."""
        if self._event.is_set():
            return False
        self._error = exc
        self._event.set()
        return True

    def wait(self, timeout, what="result not available"):
        """Block for the value; raises the stored error, or
        ``TimeoutError`` ("``{what}`` within ``{timeout}``s")."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"{what} within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value


class IndexLedger:
    """First-arrival-wins values keyed by index, timestamps kept."""

    __slots__ = ("_lock", "_values", "_times")

    def __init__(self):
        self._lock = threading.Lock()
        self._values = {}
        self._times = {}

    def record(self, index, value):
        """Record ``value`` at ``index``; True iff it was the first."""
        with self._lock:
            if index in self._values:
                return False
            self._values[index] = value
            self._times[index] = time.perf_counter()
            return True

    def values(self):
        """Recorded values in index order."""
        with self._lock:
            return [self._values[i] for i in sorted(self._values)]

    def times(self):
        """{index: perf_counter-of-first-arrival} copy."""
        with self._lock:
            return dict(self._times)

    def __len__(self):
        with self._lock:
            return len(self._values)


class DeliveryLedger:
    """Named done-sets: ``record(feed, unit)`` / ``done_units(feed)``.
    Feeders record each partition once it was fully consumed; the
    driver reads back which partitions were."""

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

    def counts(self):
        """``{feed: units done}`` for every feed, by name."""
        with self._lock:
            return {f: len(u) for f, u in sorted(self._done.items())}

    def reset(self, feed):
        """Forget ``feed``'s done-set (each ``train()`` owns one scope)."""
        with self._lock:
            self._done.pop(str(feed), None)


class KVLedger:
    """A :class:`DeliveryLedger` kept in a manager KV, one key a
    ``(feed, unit)``: writes are idempotent, never read-modify-write, so
    concurrent recorders cannot race, and the ledger lives in the
    manager's process, past the recording actor's death."""

    __slots__ = ("_mgr", "_prefix")

    def __init__(self, mgr, namespace):
        self._mgr = mgr
        self._prefix = f"actor_ledger:{namespace}:"

    def _key(self, feed, unit):
        return f"{self._prefix}{feed}:{unit!r}"

    def record(self, feed, unit):
        if self.done(feed, unit):
            return False
        self._mgr.set(self._key(feed, unit), unit)
        return True

    def done(self, feed, unit):
        try:
            return self._mgr.get(self._key(feed, unit)) is not None
        except Exception:  # noqa: BLE001 - manager tearing down
            return False

    def done_units(self, feed):
        want = f"{self._prefix}{feed}:"
        try:
            items = self._mgr.kv().items()
        except Exception:  # noqa: BLE001 - manager tearing down
            return []
        return sorted(v for k, v in items if str(k).startswith(want))


class NullLedgerClient:
    """The rendezvous client's ledger calls when no server is reachable
    (a data service or an actor run alone, in tests)."""

    def fed_partitions(self, feed):
        return []

    def partition_done(self, feed, part):
        pass

    def close(self):
        pass


def resume_cursor(done_units, start=0):
    """The first unit index >= ``start`` not in ``done_units``: where a
    respawned data worker resumes its shard."""
    done = set(done_units)
    unit = int(start)
    while unit in done:
        unit += 1
    return unit
