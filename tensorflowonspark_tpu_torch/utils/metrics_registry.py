"""Live in-process metrics registry: counters and gauges.

An own copy of the part of ``tensorflowonspark_tpu/utils/metrics_registry.py``
that the decode engine calls (``inc``, ``set_gauge``), with the same
env gate: enabled iff ``TFOS_OBS_PORT`` is set, a cached no-op
otherwise, and one registry per process (keyed by pid).  The publisher
that snapshots the registry for ``/metrics`` comes with the serving
frontend (ROADMAP.md).  Stdlib only.
"""

from __future__ import annotations

import os
import threading

PORT_ENV = "TFOS_OBS_PORT"

# name -> (type, help), the decode tier's entries of the reference catalog
CATALOG = {
    "tfos_decode_slot_occupancy": (
        "gauge", "KV-cache slots occupied after the last engine "
                 "iteration."),
    "tfos_decode_retired_total": (
        "counter", "Decode sessions retired (EOS or max_tokens)."),
    "tfos_decode_prefix_hits": (
        "counter", "Admissions that mapped trie-matched prompt-prefix "
                   "blocks instead of re-prefilling them."),
    "tfos_decode_blocks_in_use": (
        "gauge", "Paged-KV blocks referenced by live sessions or the "
                 "prefix trie (sentinel excluded)."),
}


class Registry:
    """One process's metric store; all mutation under one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"type", "help", "series": {labels_tuple: value}}
        self._metrics = {}

    def _series(self, name, mtype, labels):
        ent = self._metrics.get(name)
        if ent is None:
            mhelp = CATALOG.get(name, (mtype, ""))[1]
            ent = {"type": mtype, "help": mhelp, "series": {}}
            self._metrics[name] = ent
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        ent["series"].setdefault(key, 0.0)
        return ent["series"], key

    def inc(self, name, value=1.0, **labels):
        with self._lock:
            series, key = self._series(name, "counter", labels)
            series[key] += float(value)

    def set(self, name, value, **labels):
        with self._lock:
            series, key = self._series(name, "gauge", labels)
            series[key] = float(value)


_STATE = {"key": None, "reg": None}
_STATE_LOCK = threading.Lock()


def _get():
    key = (os.getpid(), os.environ.get(PORT_ENV))
    if _STATE["key"] == key:
        return _STATE["reg"]
    with _STATE_LOCK:
        if _STATE["key"] != key:
            _STATE["reg"] = Registry() if key[1] is not None else None
            _STATE["key"] = key
        return _STATE["reg"]


def inc(name, value=1.0, **labels):
    """Add ``value`` to a counter series (no-op when disabled)."""
    reg = _get()
    if reg is not None:
        reg.inc(name, value, **labels)


def set_gauge(name, value, **labels):
    """Set a gauge series to ``value`` (no-op when disabled)."""
    reg = _get()
    if reg is not None:
        reg.set(name, value, **labels)
