"""Driver-side dispatch state: live set, loads, in-flight table.

An own copy of ``tensorflowonspark_tpu/actors/dispatch.py``, whole: the
replica pool's membership (``up``/``down``/``lost``), least-loaded pick,
load accounting, orphan collection (``owned_by``, ``reassign``), the
request-timeout sweep (``stale``) and teardown (``drain``), under one
lock.

Keys are caller-chosen and namespaced by the caller (``("batch", id)``
vs ``("gen", sid)``), so one table serves several request kinds
without id collisions.  Entries are caller-owned dicts; the table adds
``"owner"`` and ``"t"`` (monotonic dispatch/refresh time).
"""

from __future__ import annotations

import threading
import time

__all__ = ["InFlightTable"]


class InFlightTable:
    """Lock-consistent (members x in-flight-requests) bookkeeping."""

    def __init__(self, pool_size=0):
        self._lock = threading.Lock()
        self.pool_size = int(pool_size)
        self._live = set()       # member idx with an active loop
        self._pids = {}          # idx -> os pid (latest incarnation)
        self._loads = {}         # idx -> in-flight count
        self._entries = {}       # key -> entry dict (+"owner"/"t")
        self._quiesced = set()   # live but not accepting NEW work (drain)

    # -- membership -----------------------------------------------------------
    def up(self, idx, pid):
        """Record a member's ``up``; True when this is a RESPAWN (same
        index, different pid) — the new incarnation holds nothing in
        hand, so its load resets and the caller re-dispatches."""
        with self._lock:
            respawned = idx in self._pids and self._pids[idx] != pid
            if respawned:
                self._loads[idx] = 0
            self._live.add(idx)
            self._pids[idx] = pid
            return respawned

    def down(self, idx):
        with self._lock:
            self._live.discard(idx)

    def lost(self, idx):
        """Remove a member declared dead; its load bucket goes with it
        (orphaned entries keep their ``owner`` until re-assigned)."""
        with self._lock:
            self._live.discard(idx)
            self._loads.pop(idx, None)
            self._quiesced.discard(idx)

    def quiesce(self, idx):
        """Stop routing NEW work to a live member (graceful drain: it
        keeps its in-flight entries and stays live until retired)."""
        with self._lock:
            self._quiesced.add(idx)

    def unquiesce(self, idx):
        with self._lock:
            self._quiesced.discard(idx)

    def live(self):
        with self._lock:
            return sorted(self._live)

    def pids(self):
        with self._lock:
            return dict(self._pids)

    def loads(self):
        with self._lock:
            return dict(self._loads)

    # -- dispatch -------------------------------------------------------------
    def _pick_locked(self):
        # quiesced members are skipped while any other live member can
        # take the work; when every live member is draining they are
        # still preferred over a blind pool_size guess.
        candidates = (sorted(self._live - self._quiesced)
                      or sorted(self._live)
                      or list(range(self.pool_size)))
        return min(candidates, key=lambda i: (self._loads.get(i, 0), i))

    def add(self, key, entry, owner=None):
        """Insert an in-flight entry; picks the least-loaded live member
        when ``owner`` is None.  Returns the owner chosen."""
        with self._lock:
            idx = self._pick_locked() if owner is None else owner
            entry["owner"] = idx
            entry["t"] = time.monotonic()
            self._entries[key] = entry
            self._loads[idx] = self._loads.get(idx, 0) + 1
            return idx

    def pop(self, key):
        """Resolve an entry (answer arrived): removes it and decrements
        its owner's load.  None when already resolved — the duplicate-
        answer-after-re-dispatch case, a no-op by design."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                i = entry["owner"]
                self._loads[i] = max(0, self._loads.get(i, 1) - 1)
            return entry

    def get(self, key):
        with self._lock:
            return self._entries.get(key)

    def touch(self, key):
        """Refresh an entry's liveness clock (a streamed partial answer
        proves the owner is making progress)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry["t"] = time.monotonic()
            return entry

    def reassign(self, key):
        """Move an orphaned entry to the least-loaded live member (its
        re-dispatch target); None when no member is live — the entry
        stays assigned and the respawned owner drains its inherited
        mailbox instead."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or not self._live:
                return None
            idx = self._pick_locked()
            entry["owner"] = idx
            entry["t"] = time.monotonic()
            self._loads[idx] = self._loads.get(idx, 0) + 1
            return idx

    def owned_by(self, idxs):
        """Keys of entries whose owner is in ``idxs`` (a dead member's
        orphans, in insertion order)."""
        with self._lock:
            return [k for k, e in self._entries.items()
                    if e["owner"] in idxs]

    def owned_count(self, idx):
        """In-flight entries currently assigned to ``idx`` (the drain
        loop polls this down to zero before retiring a member)."""
        with self._lock:
            return sum(1 for e in self._entries.values()
                       if e["owner"] == idx)

    def stale(self, timeout, now=None):
        """Pop and return [(key, entry)] older than ``timeout`` —
        the request-timeout sweep."""
        if not timeout:
            return []
        now = time.monotonic() if now is None else now
        out = []
        with self._lock:
            for key, entry in list(self._entries.items()):
                if now - entry["t"] > timeout:
                    self._entries.pop(key)
                    i = entry["owner"]
                    self._loads[i] = max(0, self._loads.get(i, 1) - 1)
                    out.append((key, entry))
        return out

    def keys(self):
        """All in-flight keys, insertion-ordered (introspection: callers
        count per-namespace, e.g. outstanding decode sessions)."""
        with self._lock:
            return list(self._entries)

    def drain(self):
        """Pop everything (pool teardown fails all outstanding work)."""
        with self._lock:
            entries = list(self._entries.items())
            self._entries.clear()
            self._loads.clear()
            return entries

    def __len__(self):
        with self._lock:
            return len(self._entries)
