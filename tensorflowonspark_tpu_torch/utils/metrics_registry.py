"""Live in-process metrics registry: counters, gauges and histograms.

An own copy of ``tensorflowonspark_tpu/utils/metrics_registry.py``, the
in-flight half of the observability plane: instrumented code bumps
series here (``inc``, ``set_gauge``, ``observe``), each node's
publisher ships ``snapshot()`` into its manager's KV
(``obs.publish``), and the driver's ``obs.http`` server renders the
cluster's merged series as Prometheus text (``render_text``) at
``/metrics``.  Enabled iff ``TFOS_OBS_PORT`` is set: otherwise every
call is a cached no-op, with no registry, no lock and no thread.  One
registry per process (keyed by pid), so a forked or spawned child
starts empty.  Stdlib only.

Every ``tfos_*`` name the port's code uses is in ``CATALOG`` with the
JAX package's type and help (``tests/test_torch_obs.py`` checks both).

Env vars: ``TFOS_OBS_PORT`` (the switch and the driver's HTTP port; 0
binds an ephemeral one) and ``TFOS_OBS_INTERVAL`` (the publish and poll
period, seconds, default 2).
"""

from __future__ import annotations

import math
import os
import threading

PORT_ENV = "TFOS_OBS_PORT"
INTERVAL_ENV = "TFOS_OBS_INTERVAL"

DEFAULT_INTERVAL = 2.0

# Default histogram bucket upper bounds, milliseconds (the reference's).
DEFAULT_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)

# name -> (type, help), the reference catalog whole
CATALOG = {
    # engine (driver process)
    "tfos_engine_jobs_total": (
        "counter", "Engine jobs completed, by status (ok|error)."),
    "tfos_engine_tasks_total": (
        "counter", "Engine tasks completed, by status (ok|error)."),
    "tfos_engine_task_retries_total": (
        "counter", "Task attempts re-scheduled after a retryable failure."),
    "tfos_engine_respawns_total": (
        "counter", "Executor processes respawned after death."),
    "tfos_engine_executors": (
        "gauge", "Executor processes currently alive."),
    # feed / data ring (trainer process)
    "tfos_feed_chunks_total": (
        "counter", "Chunks pulled off the feed transport."),
    "tfos_feed_records_total": (
        "counter", "Records pulled off the feed transport."),
    "tfos_feed_wait_seconds_total": (
        "counter", "Cumulative seconds the consumer blocked on the feed."),
    "tfos_feed_ring_bytes": (
        "gauge", "Bytes resident in the shm feed ring after a pull."),
    "tfos_feed_queue_depth": (
        "gauge", "Chunks resident in the manager feed queue after a pull."),
    # train step (trainer process, utils/metrics.py)
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
    # data service (data-worker process)
    "tfos_data_records_total": (
        "counter", "Records pushed to trainers, by trainer rank."),
    "tfos_data_units_total": (
        "counter", "Exactly-once ledger units recorded done."),
    "tfos_data_resumes_total": (
        "counter", "Shard-cursor resumes after a worker respawn."),
    # dynamic split dispatch (data/splits.py provider + dynamic workers)
    "tfos_data_splits_posted_total": (
        "counter", "Split ids posted to the FCFS queue by the provider."),
    "tfos_data_splits_claimed_total": (
        "counter", "Splits claimed off the queue by this worker."),
    "tfos_data_splits_served_total": (
        "counter", "Splits recorded consumption-safe in the ledger."),
    "tfos_data_splits_requeued_total": (
        "counter", "Splits of dead claimants returned to the queue."),
    "tfos_data_split_dup_chunks_total": (
        "counter", "Re-served split chunks dropped by consumer dedup."),
    "tfos_data_split_queue_depth": (
        "gauge", "Split ids waiting in the shared FCFS queue."),
    "tfos_data_workers": (
        "gauge", "Dynamic data workers in the active plan (autoscaler)."),
    # shared epoch cache (data/cache.py)
    "tfos_data_cache_hits_total": (
        "counter", "Shared-cache registry lookups that reused a cache."),
    "tfos_data_cache_misses_total": (
        "counter", "Shared-cache registry lookups that built a cache."),
    "tfos_data_cache_spilled_total": (
        "counter", "Cached blocks written to the disk spill."),
    "tfos_data_cache_blocks": (
        "gauge", "Blocks materialized in the epoch cache."),
    "tfos_data_cache_bytes": (
        "gauge", "Bytes resident in the epoch cache memory tier."),
    # serving (server process)
    "tfos_serve_requests_total": (
        "counter", "Serving requests, by status (ok|error|shed)."),
    "tfos_serve_request_ms": (
        "histogram", "End-to-end served request latency, milliseconds."),
    "tfos_serve_queue_depth": (
        "gauge", "Micro-batcher queue depth at last admission."),
    "tfos_serve_batches_total": (
        "counter", "Device batches dispatched by the micro-batcher."),
    "tfos_serve_batch_rows_total": (
        "counter", "Real (non-padding) rows in dispatched batches."),
    "tfos_serve_reloads_total": (
        "counter", "Checkpoint hot-reload broadcasts."),
    "tfos_serve_pool_generation": (
        "gauge", "Elastic pool generation (bumps on every resize; "
                 "epoch-fences stale resize acks)."),
    "tfos_serve_pool_degraded": (
        "gauge", "1 while the elastic pool serves below its logical "
                 "capacity, else 0."),
    "tfos_serve_resize_seconds": (
        "histogram", "Elastic pool resize duration (generation bump to "
                     "last replica reshard ack), seconds."),
    # serving fabric (serving/fabric/ — driver process)
    "tfos_fabric_hosts": (
        "gauge", "Live fabric host processes."),
    "tfos_fabric_replicas": (
        "gauge", "Replica workers across live fabric hosts."),
    "tfos_fabric_queue_depth": (
        "gauge", "In-flight fabric dispatches (batches + sessions)."),
    "tfos_fabric_dispatches_total": (
        "counter", "Fabric dispatches, by kind (batch|gen)."),
    "tfos_fabric_affinity_total": (
        "counter", "Fabric session routing decisions, by outcome "
                   "(hit|miss|fallback)."),
    "tfos_fabric_redispatches_total": (
        "counter", "In-flight work resent after a fabric host died, "
                   "by kind (batch|gen)."),
    "tfos_fabric_scale_events_total": (
        "counter", "Autoscale plans actuated by the fabric router, by "
                   "direction (up|down)."),
    # decode (serving/decode/ — server process + replica engines)
    "tfos_decode_sessions_total": (
        "counter", "Decode sessions, by status (ok|error|shed)."),
    "tfos_decode_tokens_total": (
        "counter", "Tokens generated by completed decode sessions."),
    "tfos_decode_ttft_ms": (
        "histogram", "Decode time-to-first-token, milliseconds."),
    "tfos_decode_token_ms": (
        "histogram", "Decode per-token gap (inter-token latency), "
                     "milliseconds."),
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
    # checkpoint (any process)
    "tfos_checkpoint_saves_total": (
        "counter", "Checkpoint saves completed."),
    "tfos_checkpoint_restores_total": (
        "counter", "Checkpoint restores completed."),
    "tfos_checkpoint_save_ms": (
        "histogram", "Checkpoint save latency, milliseconds."),
    "tfos_checkpoint_restore_ms": (
        "histogram", "Checkpoint restore latency, milliseconds."),
    # elastic SPMD runtime (elastic/)
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
    # actor substrate (actors/ — driver process)
    "tfos_actor_spawns_total": (
        "counter", "Actor member incarnations registered, by group."),
    "tfos_actor_respawns_total": (
        "counter", "Actor members respawned after death, by group."),
    "tfos_actor_mailbox_depth": (
        "gauge", "Mailbox depth observed at the last send, by group."),
    "tfos_actor_heartbeat_age_s": (
        "gauge", "Oldest live-member heartbeat age, seconds, by group."),
    # workloads (workloads/ — actor processes)
    "tfos_eval_runs_total": (
        "counter", "Eval-sidecar evaluations completed."),
    "tfos_eval_last_step": (
        "gauge", "Checkpoint step of the last completed evaluation."),
    # blessed-checkpoint deployment loop (utils/checkpoint.py manifests,
    # serving/replicas.py canary arms, workloads/deploy_loop.py controller)
    "tfos_deploy_blessed_step": (
        "gauge", "Newest checkpoint step with a blessing manifest (the "
                 "rollback target)."),
    "tfos_deploy_tombstones_total": (
        "counter", "Checkpoints quarantined by a rollback tombstone."),
    "tfos_deploy_canary_step": (
        "gauge", "Candidate checkpoint step the open canary arm serves."),
    "tfos_deploy_requests_total": (
        "counter", "Requests resolved under a canary split, by arm "
                   "(canary|baseline) and status (ok|error)."),
    "tfos_deploy_request_ms": (
        "histogram", "End-to-end request latency under a canary split, "
                     "by arm."),
    "tfos_deploy_promotions_total": (
        "counter", "Canary candidates promoted to the full pool "
                   "(bootstrap pins included)."),
    "tfos_deploy_rollbacks_total": (
        "counter", "Canary candidates auto-rolled back and tombstoned."),
    # SLO engine (obs/slo.py — driver process)
    "tfos_slo_burn_rate": (
        "gauge", "Error-budget burn rate per objective (1.0 spends the "
                 "budget exactly; >1 is a breach in progress)."),
    "tfos_slo_current": (
        "gauge", "Current tracked value per objective (latency: the "
                 "target-quantile milliseconds; availability: the good "
                 "fraction)."),
    "tfos_slo_breaches_total": (
        "counter", "Objective transitions into breach (burn crossing "
                   "above 1), by objective."),
    # training-health watchtower (obs/health.py — trainer process;
    # tfos_node_skew on the driver)
    "tfos_health_anomalies_total": (
        "counter", "Edge-triggered training anomalies, by kind "
                   "(nan|loss_spike|slow_step|infeed_stall)."),
    "tfos_health_status": (
        "gauge", "Health of this process's training loop: 0 ok, "
                 "1 degraded (an anomaly fired and has not cleared)."),
    "tfos_health_last_anomaly_step": (
        "gauge", "Step index of the most recent anomaly, by kind."),
    "tfos_health_grad_norm": (
        "gauge", "Device-computed global gradient norm from the last "
                 "step (only under TFOS_HEALTH_GRADNORM=1)."),
    "tfos_health_captures_total": (
        "counter", "On-demand captures served by the publish daemon, "
                   "by kind (profile|flight) and status (ok|degraded)."),
    "tfos_node_skew": (
        "gauge", "Driver-side straggler skew: slowest node's median "
                 "step time over the fastest node's (1.0 = balanced)."),
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

    def snapshot(self):
        """A plain-data copy of every series (picklable, JSON-able): the
        payload a node publishes."""
        out = {}
        with self._lock:
            for name, ent in self._metrics.items():
                series = []
                for key, val in ent["series"].items():
                    s = {"labels": dict(key)}
                    if isinstance(val, _Hist):
                        s.update(bounds=list(val.bounds),
                                 counts=list(val.counts), sum=val.sum,
                                 count=val.count)
                    else:
                        s["value"] = val
                    series.append(s)
                out[name] = {"type": ent["type"], "help": ent["help"],
                             "series": series}
        return out


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


def reset():
    """Drop this process's registry (tests isolate series with it)."""
    with _STATE_LOCK:
        _STATE["key"] = None
        _STATE["reg"] = None


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


def snapshot():
    """This process's registry snapshot, or None when disabled."""
    reg = _get()
    return reg.snapshot() if reg is not None else None


def interval():
    """The publish and poll period, seconds (``TFOS_OBS_INTERVAL``)."""
    try:
        return max(0.05, float(os.environ.get(INTERVAL_ENV,
                                              str(DEFAULT_INTERVAL))))
    except ValueError:
        return DEFAULT_INTERVAL


# -- rendering ----------------------------------------------------------------

def _escape(v):
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labelstr(labels):
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"'
                          for k, v in sorted(labels.items())) + "}"


def _fmt(v):
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def render_text(snapshots):
    """Prometheus text exposition of ``[(extra_labels, snapshot), ...]``
    (one pair a node, ``extra_labels`` as ``{"node": node_id}``): every
    node's series of a name under one ``# HELP`` / ``# TYPE`` header,
    histograms as cumulative ``_bucket`` lines, ``_sum`` and
    ``_count``."""
    merged = {}  # name -> (type, help, [(labels, series)])
    for extra, snap in snapshots:
        for name, ent in (snap or {}).items():
            slot = merged.setdefault(
                name, (ent.get("type", "gauge"), ent.get("help", ""), []))
            for s in ent.get("series", ()):
                slot[2].append((dict(s.get("labels", {}), **(extra or {})),
                                s))
    lines = []
    for name in sorted(merged):
        mtype, mhelp, series = merged[name]
        if mhelp:
            lines.append(f"# HELP {name} {mhelp}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, s in series:
            if mtype != "histogram":
                lines.append(f"{name}{_labelstr(labels)} "
                             f"{_fmt(s.get('value', 0))}")
                continue
            cum = 0
            bounds = list(s.get("bounds", ())) + [math.inf]
            for b, c in zip(bounds, s.get("counts", ())):
                cum += c
                lines.append(f"{name}_bucket"
                             f"{_labelstr(dict(labels, le=_fmt(b)))} {cum}")
            lines.append(f"{name}_sum{_labelstr(labels)} "
                         f"{_fmt(s.get('sum', 0))}")
            lines.append(f"{name}_count{_labelstr(labels)} "
                         f"{_fmt(s.get('count', 0))}")
    return "\n".join(lines) + ("\n" if lines else "")


def quantile(series, q):
    """Quantile ``q`` (0..1) of one histogram series (snapshot form:
    ``bounds``, ``counts``, ``count``), interpolated linearly inside its
    bucket; the +Inf bucket clamps to the last finite bound.  None for
    an empty series."""
    count = series.get("count", 0)
    if not count:
        return None
    bounds = list(series.get("bounds", ()))
    target = q * count
    cum = lo = 0.0
    for i, c in enumerate(series.get("counts", ())):
        if cum + c >= target and c:
            if i >= len(bounds):  # +Inf bucket: clamp
                return float(bounds[-1] if bounds else lo)
            frac = (target - cum) / c
            return float(lo + (bounds[i] - lo) * frac)
        cum += c
        lo = bounds[i] if i < len(bounds) else lo
    return float(bounds[-1]) if bounds else None
