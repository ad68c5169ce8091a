"""Session-affinity routing primitives for the serving fabric.

An own copy of ``tensorflowonspark_tpu/serving/fabric/affinity.py``,
pure stdlib: a returning ``/v1/generate`` session should land on the
worker whose paged KV cache still holds its prefix blocks, since a
re-prefill elsewhere pays the whole prompt again.

- :class:`Ring`: a consistent-hash ring over ``(host, worker)``
  endpoints.  Hashing is md5's, so placement is the same in every
  process and in both packages (a key maps to the same endpoint as in
  JAX), and adding or removing one endpoint remaps only its keys.
- :class:`AffinityMap`: a bounded LRU of ``route_id -> endpoint``
  bindings.  The binding, not the ring, holds for a returning session:
  after a failover the router rebinds the route to the survivor that
  re-prefilled it.

Neither knows of liveness or load: the router decides when a target is
dead or saturated and falls back (outcome ``"fallback"``).
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from collections import OrderedDict

DEFAULT_VNODES = 64
DEFAULT_BINDINGS = 4096


def _hash64(data):
    """Deterministic 64-bit hash of a string (md5 prefix)."""
    return int.from_bytes(
        hashlib.md5(data.encode("utf-8", "replace")).digest()[:8], "big")


class Ring:
    """Consistent-hash ring over hashable endpoints.

    ``vnodes`` virtual points per endpoint smooth the key distribution;
    with one endpoint every key maps to it, with zero endpoints
    :meth:`lookup` raises.  Endpoints are placed by the md5 of their
    ``repr`` plus the vnode index, so two rings built from the same
    endpoint set agree everywhere.
    """

    def __init__(self, endpoints, vnodes=DEFAULT_VNODES):
        self.endpoints = tuple(endpoints)
        if not self.endpoints:
            raise ValueError("Ring needs at least one endpoint")
        points = []
        for ep in self.endpoints:
            for v in range(int(vnodes)):
                points.append((_hash64(f"{ep!r}#{v}"), ep))
        points.sort()
        self._points = points
        self._keys = [p[0] for p in points]

    def lookup(self, key):
        """The endpoint owning ``key`` (first point clockwise)."""
        h = _hash64(str(key))
        i = bisect.bisect_right(self._keys, h)
        if i >= len(self._points):
            i = 0
        return self._points[i][1]


class AffinityMap:
    """Bounded LRU of ``route_id -> endpoint`` bindings (thread-safe).

    ``bind`` inserts or refreshes; ``get`` refreshes recency on hit, so
    an active session is never the one evicted.  Eviction only forgets
    the *hint* — a forgotten route re-routes through the ring and at
    worst re-prefills once.
    """

    def __init__(self, capacity=DEFAULT_BINDINGS):
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError("AffinityMap capacity must be >= 1")
        self._map = OrderedDict()
        self._lock = threading.Lock()

    def get(self, route_id):
        with self._lock:
            ep = self._map.get(route_id)
            if ep is not None:
                self._map.move_to_end(route_id)
            return ep

    def bind(self, route_id, endpoint):
        with self._lock:
            self._map[route_id] = endpoint
            self._map.move_to_end(route_id)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def pop(self, route_id):
        with self._lock:
            return self._map.pop(route_id, None)

    def __len__(self):
        with self._lock:
            return len(self._map)
