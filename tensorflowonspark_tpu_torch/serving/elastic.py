"""Elastic serving: a replica pool that degrades by resize.

An own copy of ``tensorflowonspark_tpu/serving/elastic.py``, on the
port's :class:`~.replicas.ReplicaPool`:

- the pool declares a logical capacity (``logical_replicas`` slots);
  each live replica covers its share (:func:`assign_slots`), recomputed
  on every membership change;
- a lost replica triggers a resize, not a reload: the pool's generation
  bumps (stale acks and stale directives are dropped by generation),
  survivors take the new shares, and in-flight work is re-dispatched
  through the resolve-once ledger (orphaned decode sessions re-prefill
  on their new owner);
- a respawned incarnation announces itself (``hello``) and is handed the
  survivors' params mirror to adopt: it rejoins from live params, never
  from a checkpoint or an export;
- while shrunk, admission declares degraded mode
  (``MicroBatcher.set_capacity``): load past the shrunk capacity is shed
  with Retry-After, never dropped;
- ``drain(replica)`` retires one replica gracefully.

On the card each replica holds one device, so a resize changes the
logical mesh's bookkeeping (``_Predictor.mesh_shape``, which keys the
compile-count contract) and places nothing: the placement is the
identity (:func:`apply_resize`).  The mirror crosses processes as a
pickled tree of host numpy arrays (:func:`params_blob`).

Chaos: ``serve.resize`` fires at the top of every resize attempt (a
failed resize is retried on the monitor's next pass).
"""

from __future__ import annotations

import logging
import os
import pickle
import queue as _queue
import threading
import time
import weakref

from tensorflowonspark_tpu_torch.serving.replicas import (
    ReplicaPool,
    _import_qualname,
    _Predictor,
)
from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)

__all__ = ["ElasticReplicaPool", "assign_slots", "pool_table"]

BOOT_WAIT_ENV = "TFOS_SERVE_BOOT_WAIT"

#: tfos_serve_resize_seconds buckets: a resize is an IPC round, not the
#: millisecond ladder of DEFAULT_BUCKETS_MS.
RESIZE_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0, 30.0)

#: The live elastic pools of this process, for /statusz's pools section.
_POOLS = weakref.WeakSet()


def pool_table():
    """``[{generation, live, capacity, ...}]``: one row a live elastic
    pool (``obs/http.py`` renders it as /statusz's ``pools``)."""
    rows = []
    for pool in list(_POOLS):
        try:
            rows.append(pool.describe())
        except Exception:  # noqa: BLE001 - introspection never raises
            logger.debug("pool describe failed", exc_info=True)
    return rows


def assign_slots(logical, live):
    """Spread ``logical`` capacity slots over the ``live`` replica
    indices, evenly, the remainder to the lowest: ``{idx: covered}``."""
    live = sorted(live)
    if not live:
        return {}
    base, rem = divmod(int(logical), len(live))
    return {idx: base + (1 if pos < rem else 0)
            for pos, idx in enumerate(live)}


# -- the replica's side (serving/replicas._ReplicaTask) ---------------------

def boot_wait_default():
    return float(os.environ.get(BOOT_WAIT_ENV, "20"))


def await_boot(inq, timeout=None):
    """The replica's boot gate, after its ``hello``: ``("cold",)``,
    ``("adopt", version, params)`` or ``("stop",)``.  Without a
    directive in ``timeout`` (``TFOS_SERVE_BOOT_WAIT``, 20 s) it boots
    cold, so a pool whose supervisor died still comes up.  Other
    messages in the inherited inbox (a dead incarnation's work) are
    dropped: the pool re-dispatches all of it once this one is up."""
    deadline = time.monotonic() + (boot_wait_default() if timeout is None
                                   else timeout)
    while time.monotonic() < deadline:
        try:
            msg = inq.get(timeout=0.25)
        except _queue.Empty:
            continue
        except Exception:  # noqa: BLE001 - the manager is gone: boot cold
            break
        if msg[0] == "boot":
            if msg[1] == "adopt":
                return ("adopt", msg[2], pickle.loads(msg[3]))
            return ("cold",)
        if msg[0] == "stop":
            return ("stop",)
    logger.warning("no boot directive within the wait; booting cold")
    return ("cold",)


def adopt_predictor(payload, version, params, device=None):
    """A replica's predictor from adopted live params.  Only the predict
    function is resolved from the spec or the export's metadata
    (``load_export_meta`` reads no params); the params are the mirror,
    so the replica serves the pool's version with the checkpoint files
    gone.  They reach ``device`` as a cold boot's do: the decode engine,
    or a predict called with ``device=``, places the host tree there."""
    if params is None:
        raise ValueError("adopt directive carried no params")
    fn = payload.get("predict")
    if payload.get("export_dir") and not callable(fn):
        from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

        meta = ckpt.load_export_meta(payload["export_dir"])
        spec = (fn if isinstance(fn, str) else None) or meta.get("predict")
        fn = _import_qualname(spec) if spec else None
    elif isinstance(fn, str):
        fn = _import_qualname(fn)
    return _Predictor(fn, params, version, device)


def _host_tree(tree):
    from tensorflowonspark_tpu_torch.utils.checkpoint import _to_host

    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return _to_host(tree)


def params_blob(params):
    """The pool's adoption mirror of live params: every leaf copied to
    host numpy (a CUDA tensor never crosses a process), pickled."""
    return pickle.dumps(_host_tree(params), protocol=pickle.HIGHEST_PROTOCOL)


def apply_resize(pred, covered, logical):
    """The replica's resize to ``covered`` of ``logical`` slots; returns
    its milliseconds.  The logical mesh is ``data = covered``; with one
    card a replica the placement is the identity, so only
    ``pred.mesh_shape`` changes (it keys the compile-count contract, as
    in the JAX package, where the params are also re-placed)."""
    t0 = time.perf_counter()
    del logical
    pred.mesh_shape = (("data", max(1, int(covered))),)
    return (time.perf_counter() - t0) * 1e3


# -- the pool ----------------------------------------------------------------

class ElasticReplicaPool(ReplicaPool):
    """A ReplicaPool that degrades by resize instead of blinking out,
    through the base pool's ``_payload``/``_handle_extra``/``_tick``
    hooks: engine respawn, manager IPC, the liveness scan and the
    in-flight table's re-dispatch are the base pool's."""

    def __init__(self, spec, num_replicas=None, logical_replicas=None,
                 on_capacity=None, engine=None, env=None, max_retries=None,
                 request_timeout=None):
        super().__init__(spec, num_replicas=num_replicas, engine=engine,
                         env=env, max_retries=max_retries,
                         request_timeout=request_timeout)
        self.logical_replicas = int(logical_replicas or self.num_replicas)
        if self.logical_replicas < self.num_replicas:
            raise ValueError(
                f"logical_replicas={self.logical_replicas} < "
                f"num_replicas={self.num_replicas}: the logical capacity "
                "is the pool's full-strength shape")
        self._on_capacity = on_capacity
        self._el_lock = threading.RLock()
        self.generation = 0
        self.capacity_frac = 0.0     # no one is live until start()
        self.resizes = 0
        self.adoptions = 0
        self.last_resize_s = None
        self._assignments = {}       # idx -> covered logical slots
        self._draining = set()
        # idx -> the dead incarnation's pid: its hello came, its new pid
        # is not registered yet, so the old one is dead even where the
        # monitor's death scan never saw it
        self._booting = {}
        # the (idx, pid) membership the last resize covered: a respawn
        # (same idx, new pid) is a change too
        self._resized_for = None
        self._resize_pending = {}    # gen -> {idx awaiting its ack}
        self._resize_t0 = {}         # gen -> perf_counter at the bump
        self._mirror_version = None  # the mirrored params' version
        self._mirror_blob = None
        self.mirror_bytes = None     # the mirror's pickled size

    # -- the base pool's hooks ------------------------------------------------
    def _payload(self):
        payload = super()._payload()
        payload["elastic"] = {"logical": self.logical_replicas}
        return payload

    def _handle_extra(self, msg):
        kind = msg[0]
        if kind == "hello":
            _, idx, pid = msg
            # a hello from an index with a recorded incarnation proves
            # that one dead, even where the respawn beat the monitor's
            # scan: shrink now, so the degraded window is declared.  The
            # pool's first hellos (no pid yet) resize nothing: start()
            # forms the pool once.
            dead_pid = self._table.pids().get(idx)
            if dead_pid is not None:
                with self._el_lock:
                    self._booting[idx] = dead_pid
                self._maybe_resize(f"replica {idx} rebooting")
            with self._el_lock:
                blob = self._mirror_blob
                version = self._mirror_version
            if blob is not None:
                self.adoptions += 1
                telemetry.event("serve/pool_adopt", replica=idx,
                                version=version)
                self._send(idx, ("boot", "adopt", version, blob))
            else:
                self._send(idx, ("boot", "cold"))
            return True
        if kind == "params_sync":
            _, idx, version, blob = msg
            with self._el_lock:
                if self._accept_mirror(version):
                    self._mirror_version, self._mirror_blob = version, blob
                    self.mirror_bytes = len(blob)
            return True
        if kind == "resized":
            _, idx, gen, covered, replica_ms = msg
            with self._el_lock:
                if gen != self.generation:
                    return True  # a stale ack: fenced
                pending = self._resize_pending.get(gen)
                if pending is None:
                    return True
                pending.discard(idx)
                if pending:
                    return True
                del self._resize_pending[gen]
                dur = time.perf_counter() - self._resize_t0.pop(gen)
                self.last_resize_s = dur
            metrics_registry.observe("tfos_serve_resize_seconds", dur,
                                     buckets=RESIZE_BUCKETS_S)
            telemetry.event("serve/pool_resized", generation=gen,
                            seconds=round(dur, 4))
            return True
        if kind == "resize_error":
            _, idx, gen, err = msg
            logger.warning("replica %s failed resize gen %s: %s",
                           idx, gen, err)
            telemetry.event("serve/pool_resize_error", replica=idx,
                            generation=gen, error=str(err)[:200])
            with self._el_lock:
                self._resized_for = None  # the next pass resizes anew
            return True
        return False

    def _accept_mirror(self, version):
        """Should a ``params_sync`` at ``version`` replace the mirror?
        Keyed to the pool's pinned version: the promotion watermark W,
        else the step the latest-wins watcher broadcast.  The newest
        version <= W wins; one > W (a canary's candidate, a respawn's
        never-broadcast checkpoint) only when the mirror is empty or
        already past W.  Without either watermark, the newest wins."""
        wm = self.watermark()
        if wm is None:
            wm = self.reload_watermark()
        cur = self._mirror_version
        if wm is None:
            return cur is None or version >= cur
        if version <= wm:
            return cur is None or cur > wm or version >= cur
        return cur is None or (cur > wm and version >= cur)

    def _tick(self):
        self._maybe_resize("membership changed")

    # -- lifecycle ------------------------------------------------------------
    def start(self, timeout=180.0):
        super().start(timeout=timeout)
        _POOLS.add(self)
        # form the pool now, not at the monitor's first pass
        self._maybe_resize("formed")
        return self

    def stop(self):
        _POOLS.discard(self)
        super().stop()

    # -- resize ---------------------------------------------------------------
    def _maybe_resize(self, reason):
        with self._el_lock:
            pids = self._table.pids()
            # a booting exclusion holds while the table still shows the
            # dead incarnation's pid; the new one's up dissolves it
            for i in [i for i, p in self._booting.items()
                      if pids.get(i) != p]:
                del self._booting[i]
            live = tuple(i for i in self._table.live()
                         if i not in self._draining
                         and i not in self._booting)
            sig = tuple((i, pids.get(i)) for i in live)
            if sig == self._resized_for:
                return
            if not live:
                # nothing to resize onto: declare zero capacity (the
                # batcher sheds everything, explicitly) until a respawn
                self._resized_for = sig
                self._apply_capacity(0.0)
                return
            try:
                self._resize(live, reason)
                self._resized_for = sig
            except Exception as e:  # noqa: BLE001 - injected faults too
                logger.warning("pool resize (%s) failed; the next pass "
                               "retries: %s", reason, e)

    def _resize(self, live, reason):
        """One generation bump: fence, assign, re-admit."""
        faults.check("serve.resize", reason=reason, live=len(live))
        t0 = time.perf_counter()
        self.generation += 1
        gen = self.generation
        self._assignments = assign_slots(self.logical_replicas, live)
        frac = min(1.0, len(live) / float(self.logical_replicas))
        self.resizes += 1
        metrics_registry.set_gauge("tfos_serve_pool_generation", gen)
        telemetry.event("serve/pool_resize", generation=gen, reason=reason,
                        live=list(live), capacity=round(frac, 4),
                        assignments={str(k): v for k, v
                                     in sorted(self._assignments.items())})
        try:  # a flight dump of the degrade or regrow, never blocking it
            from tensorflowonspark_tpu_torch.obs import flight

            flight.snapshot("serve/pool_resize", node="serve-pool",
                            reason=f"{reason}: gen {gen} -> {list(live)}",
                            inflight=self._inflight_summary())
        except Exception:  # noqa: BLE001 - dumps are best-effort
            logger.debug("flight snapshot failed", exc_info=True)
        self._resize_pending[gen] = set(live)
        self._resize_t0[gen] = t0
        # older generations can never complete now
        for old in [g for g in self._resize_pending if g < gen]:
            self._resize_pending.pop(old, None)
            self._resize_t0.pop(old, None)
        for idx in live:
            self._send(idx, ("resize", gen, self._assignments.get(idx, 0),
                             self.logical_replicas))
        self._apply_capacity(frac)

    def _apply_capacity(self, frac):
        self.capacity_frac = frac
        degraded = frac < 1.0
        metrics_registry.set_gauge("tfos_serve_pool_degraded",
                                   1.0 if degraded else 0.0)
        if self._on_capacity is not None:
            try:
                self._on_capacity(frac, self.generation, degraded)
            except Exception:  # noqa: BLE001 - the admission hook must
                # not wedge the pool
                logger.exception("on_capacity hook failed")

    @property
    def degraded(self):
        return self.capacity_frac < 1.0

    # -- graceful drain -------------------------------------------------------
    def drain(self, idx, timeout=30.0):
        """Retire replica ``idx``: stop admission to it, resize its share
        away, let its in-flight work finish (re-dispatching what remains
        at the deadline), then stop it; its task returns and is not
        respawned.  True when it left the live set within ``timeout``."""
        idx = int(idx)
        live = self._table.live()
        if idx not in live:
            raise ValueError(f"replica {idx} is not live ({live})")
        if set(live) - self._draining <= {idx}:
            raise ValueError("cannot drain the last live replica")
        telemetry.event("serve/pool_drain", replica=idx)
        self._draining.add(idx)
        self._table.quiesce(idx)
        self._maybe_resize(f"drain {idx}")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self._table.owned_count(idx):
                break
            time.sleep(0.05)
        else:
            # still holding work at the deadline: hand it to survivors
            self._redispatch({idx})
        self._send(idx, ("stop",))
        while time.monotonic() < deadline and idx in self._table.live():
            time.sleep(0.05)
        return idx not in self._table.live()

    # -- introspection --------------------------------------------------------
    def describe(self):
        with self._el_lock:
            return {
                "generation": self.generation,
                "logical": self.logical_replicas,
                "live": self._table.live(),
                "draining": sorted(self._draining),
                "capacity": round(self.capacity_frac, 4),
                "degraded": self.degraded,
                "resizes": self.resizes,
                "adoptions": self.adoptions,
                "mirror_version": self._mirror_version,
                "mirror_bytes": self.mirror_bytes,
                "last_resize_ms": (round(self.last_resize_s * 1e3, 3)
                                   if self.last_resize_s is not None
                                   else None),
                "assignments": {str(k): v for k, v
                                in sorted(self._assignments.items())},
            }
