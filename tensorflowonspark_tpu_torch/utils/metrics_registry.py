"""Live in-process metrics registry: counters, gauges and histograms.

An own copy of the part of ``tensorflowonspark_tpu/utils/metrics_registry.py``
that the decode engine, ``TrainMetrics``, ``DataFeed``, the cluster's
recovery and the elastic runtime call (``inc``,
``set_gauge``, ``observe``), with the same env gate: enabled iff
``TFOS_OBS_PORT`` is set, a cached no-op otherwise, and one registry per
process (keyed by pid).  The publisher that snapshots the registry for
``/metrics`` comes with the serving frontend (ROADMAP.md).  Stdlib only.
"""

from __future__ import annotations

import os
import threading

PORT_ENV = "TFOS_OBS_PORT"

# Default histogram bucket upper bounds, milliseconds (the reference's).
DEFAULT_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)

# name -> (type, help), the decode tier's, the feed's and the train step's
# entries of the reference catalog
CATALOG = {
    "tfos_train_steps_total": (
        "counter", "Timed train steps completed."),
    "tfos_train_step_ms": (
        "histogram", "Train step wall time, milliseconds."),
    "tfos_train_items_per_sec": (
        "gauge", "Training throughput over the metrics window."),
    "tfos_train_infeed_stall_frac": (
        "gauge", "Fraction of step time spent waiting on the feed."),
    "tfos_train_mfu": (
        "gauge", "Model FLOPs utilization (2 FLOPs/MAC convention)."),
    "tfos_feed_ring_bytes": (
        "gauge", "Bytes resident in the shm feed ring after a pull."),
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
    "tfos_decode_spec_accept": (
        "gauge", "Speculative-decode draft acceptance rate (accepted / "
                 "proposed, cumulative)."),
    "tfos_elastic_resizes_total": (
        "counter", "Mesh/cluster elastic resizes, by scope "
                   "(runtime|cluster)."),
    "tfos_elastic_mesh_devices": (
        "gauge", "Physical devices in the current elastic mesh."),
    "tfos_elastic_virtual_devices": (
        "gauge", "Virtual devices (logical mesh size) of the TrainSpec."),
    "tfos_elastic_accum_steps": (
        "gauge", "Gradient-accumulation steps folding virtual onto "
                 "physical devices."),
    "tfos_elastic_reshard_ms": (
        "histogram", "Train-state reshard latency (host round-trip), "
                     "milliseconds."),
}


class _Hist:
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # last bin = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        v = float(value)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class Registry:
    """One process's metric store; all mutation under one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"type", "help", "series": {labels_tuple: value|_Hist}}
        self._metrics = {}

    def _series(self, name, mtype, labels, default=float):
        ent = self._metrics.get(name)
        if ent is None:
            mhelp = CATALOG.get(name, (mtype, ""))[1]
            ent = {"type": mtype, "help": mhelp, "series": {}}
            self._metrics[name] = ent
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        if key not in ent["series"]:
            ent["series"][key] = default()
        return ent["series"], key

    def inc(self, name, value=1.0, **labels):
        with self._lock:
            series, key = self._series(name, "counter", labels)
            series[key] += float(value)

    def set(self, name, value, **labels):
        with self._lock:
            series, key = self._series(name, "gauge", labels)
            series[key] = float(value)

    def observe(self, name, value, buckets=None, **labels):
        with self._lock:
            series, key = self._series(
                name, "histogram", labels,
                lambda: _Hist(buckets or DEFAULT_BUCKETS_MS))
            series[key].observe(value)


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


def enabled():
    """True when the live metrics plane is recording in this process."""
    return _get() is not None


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


def observe(name, value, buckets=None, **labels):
    """Record one histogram observation (no-op when disabled)."""
    reg = _get()
    if reg is not None:
        reg.observe(name, value, buckets=buckets, **labels)
