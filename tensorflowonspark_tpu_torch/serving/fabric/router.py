"""FabricRouter: the driver's cross-host dispatch for the serving fabric.

An own copy of ``tensorflowonspark_tpu/serving/fabric/router.py``.  The
router speaks the pool protocol of ``serving.replicas.ReplicaPool``
(``start``/``stop``/``dispatch``/``dispatch_session``/``cancel_session``
/``stats``/...), so ``serving.server.Server`` mounts it unchanged; its
members are fabric hosts (one engine executor each, N worker replicas
inside, ``fabric/host.py``):

- Cross-host addressing: envelopes ride per-host manager queues, sent
  from one router thread (``_send``, as the replica pool's); membership,
  each host's load and every in-flight batch or session live in
  ``actors.dispatch.InFlightTable`` keyed by host.  A SIGKILLed host's
  in-flight entries re-dispatch to survivors, and batches and sessions
  resolve once, so a duplicate answer is a no-op.
- Session affinity: ``dispatch_session`` routes a session with a
  ``route_id`` to the ``(host, worker)`` whose paged KV cache still
  holds its prefix: a live binding wins (``"hit"``), an unknown route
  goes through the consistent-hash ring (``"miss"``), a dead or
  saturated target falls back least-loaded (``"fallback"``).  The
  outcome rides the session's result meta (``"affinity"``).
- Autoscaling: the router publishes each host's ``{workers, depth}``
  (``fabric:load``) and applies the ``ServeAutoscaler``'s plan
  (``fabric:plan``) as generation-fenced ``("scale", gen, n)``
  directives; their acks update the worker map the ring is built on.
- Version convergence: a respawned host boots at the newest checkpoint;
  ``_enforce_version`` steers it to the promotion watermark when one is
  set, else to the step the latest-wins watcher last broadcast.

Chaos sites: ``serve.fabric_dispatch`` before an envelope is routed,
``serve.fabric_route`` in the affinity pick.
"""

from __future__ import annotations

import logging
import os
import pickle
import queue as _queue
import threading
import time
import weakref

from tensorflowonspark_tpu_torch import manager as tfmanager
from tensorflowonspark_tpu_torch.actors import liveness
from tensorflowonspark_tpu_torch.actors.dispatch import InFlightTable
from tensorflowonspark_tpu_torch.serving.fabric import host as _host
from tensorflowonspark_tpu_torch.serving.fabric.affinity import (
    AffinityMap,
    Ring,
)
from tensorflowonspark_tpu_torch.serving.replicas import (
    max_retries_default,
    reload_secs_default,
)
from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)

HOSTS_ENV = "TFOS_FABRIC_HOSTS"

#: The live routers, for /statusz's pods section.
_ROUTERS = weakref.WeakSet()


def num_hosts_default():
    return int(os.environ.get(HOSTS_ENV, "2"))


def fabric_table():
    """A row a host of every live router (/statusz's ``pods`` and the
    ``tfos-top-torch --pods`` pane)."""
    rows = []
    for n, router in enumerate(list(_ROUTERS)):
        try:
            desc = router.describe()
        except Exception:  # noqa: BLE001 - the router is tearing down
            logger.debug("fabric_table: describe failed", exc_info=True)
            continue
        for hrow in desc.get("hosts", ()):
            rows.append(dict(hrow, router=n))
    return rows


class FabricRouter:
    """Owns the fabric hosts' engine job, the IPC manager, affinity
    routing, failover and the autoscaler; ``Server(..., fabric=True)``
    mounts it as its ``pool``."""

    def __init__(self, spec, num_hosts=None, replicas_per_host=1,
                 engine=None, env=None, max_retries=None,
                 request_timeout=None, autoscale=False,
                 affinity_max_load=None):
        self.spec = spec
        self.num_hosts = int(num_hosts or num_hosts_default())
        self.replicas_per_host = max(1, int(replicas_per_host))
        self._engine = engine
        self._owns_engine = engine is None
        self._env = dict(env) if env else None
        self._max_retries = (max_retries_default() if max_retries is None
                             else int(max_retries))
        self._request_timeout = request_timeout
        # autoscale: False | True | {ServeAutoscaler kwargs, tick_secs}
        self._autoscale = autoscale
        self._asys = None
        self._mgr = None
        self._inqs = {}
        self._outq = None
        self._sendq = _queue.Queue()  # (host, message) for the sender
        self._lock = threading.Lock()
        self._table = InFlightTable(self.num_hosts)
        self._workers = {}           # host -> acked worker count
        self._versions = {}          # host -> last acked params version
        self._watermark = None       # the promotion pin (set_watermark)
        self._reload_watermark = None  # newest latest-wins broadcast
        self._affinity = AffinityMap()
        self._ring = None
        self._ring_sig = None
        self._rr = 0
        decode = getattr(spec, "decode", None)
        self._sat_load = int(affinity_max_load
                             or (decode.slots if decode is not None else 8))
        self._aff = {"hit": 0, "miss": 0, "fallback": 0}
        self._aff_host = {}          # host -> outcome counts
        self._gen = 0                # the scale directives' fence
        self._plan_applied = 0
        self._last_pub = 0.0
        self.scale_ups = 0
        self.scale_downs = 0
        self.redispatched = 0
        self.replayed_tokens = 0     # duplicate token arrivals, dropped
        self.scale_times = []        # (host, workers, directive t, ack t)
        self._scale_sent = {}        # gen -> (host, workers, monotonic)
        self.lost_times = {}         # host -> [monotonic time of each loss]
        self.up_times = {}           # host -> [monotonic time of each up]
        self._stats_replies = {}
        self._stats_event = threading.Event()
        self._registered = threading.Event()
        self._init_errors = {}       # host -> message, during start()
        self._job_error = None
        self._stop = threading.Event()
        self._threads = []
        self.respawns_observed = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self, timeout=180.0):
        """Launch the hosts and wait until all are up (then the
        autoscaler).  Raises on a host's init error, the job's failure
        or the timeout, with the router stopped first."""
        if self._mgr is not None:
            return self
        try:
            self._start(timeout)
        except BaseException:
            self.stop()
            raise
        _ROUTERS.add(self)
        return self

    def _start(self, timeout):
        if self._owns_engine:
            from tensorflowonspark_tpu_torch.engine import LocalEngine

            self._engine = LocalEngine(self.num_hosts, env=self._env)
        if self.num_hosts > self._engine.num_executors:
            raise ValueError(
                f"{self.num_hosts} fabric hosts need as many executors; "
                f"the engine has {self._engine.num_executors}")
        authkey = os.urandom(16)
        self._mgr = tfmanager.start(
            authkey,
            [_host.OUT_QUEUE]
            + [_host._in_queue(h) for h in range(self.num_hosts)])
        self._inqs = {h: self._mgr.get_queue(_host._in_queue(h))
                      for h in range(self.num_hosts)}
        self._outq = self._mgr.get_queue(_host.OUT_QUEUE)
        payload = dict(self.spec.to_payload(),
                       fabric={"replicas_per_host": self.replicas_per_host})
        task = _host._HostTask(pickle.dumps(payload),
                               tuple(self._mgr.address), authkey)

        def _launch():
            try:
                ds = self._engine.parallelize(
                    list(range(self.num_hosts)), self.num_hosts)
                ds.foreach_partition(task, spread=True, retryable=True,
                                     max_retries=self._max_retries)
            except BaseException as e:  # noqa: BLE001 - surfaced by start
                self._job_error = e
                if not self._stop.is_set():
                    logger.error("fabric host job failed: %s", e)

        for name, target in (("tfos-fabric-launch", _launch),
                             ("tfos-fabric-send", self._sender),
                             ("tfos-fabric-collect", self._collect),
                             ("tfos-fabric-monitor", self._monitor)):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        if self.spec.ckpt_dir:
            t = threading.Thread(target=self._watch_reload,
                                 name="tfos-fabric-reload", daemon=True)
            t.start()
            self._threads.append(t)
        if self._autoscale:
            # the autoscaler's executor boots beside the hosts; its actor
            # starts once they are up
            from tensorflowonspark_tpu_torch.actors.runtime import (
                ActorSystem,
            )

            self._asys = ActorSystem(1, env=self._env)
        deadline = time.monotonic() + timeout
        while len(self._table.live()) < self.num_hosts:
            if self._init_errors:
                h, err = sorted(self._init_errors.items())[0]
                raise RuntimeError(f"fabric host {h} failed to start: {err}")
            if self._job_error is not None:
                raise RuntimeError(
                    f"fabric failed to start: {self._job_error}")
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"fabric hosts not up within {timeout}s "
                    f"({len(self._table.live())}/{self.num_hosts})")
            self._registered.wait(0.2)
            self._registered.clear()
        self._init_errors = None   # later init errors only log
        if self._autoscale:
            self._start_autoscaler(authkey)

    def _start_autoscaler(self, authkey):
        """The supervised ServeAutoscaler on this router's manager KV, in
        an ActorSystem of its own (its own executor process)."""
        from tensorflowonspark_tpu_torch.actors.policy import (
            SupervisionPolicy,
        )
        from tensorflowonspark_tpu_torch.serving.fabric.autoscale import (
            ServeAutoscaler,
        )

        opts = (dict(self._autoscale) if isinstance(self._autoscale, dict)
                else {})
        tick = float(opts.pop("tick_secs", 0.5))
        actor = ServeAutoscaler(mgr_addr=tuple(self._mgr.address),
                                mgr_authkey=authkey, **opts)
        self._asys.spawn(actor, "serve-autoscaler",
                         policy=SupervisionPolicy(tick_secs=tick))

    def stop(self):
        """Stop the autoscaler, fail what is in flight, stop the hosts,
        join their job, then the engine (if owned) and the manager."""
        if self._stop.is_set():
            return
        self._stop.set()
        _ROUTERS.discard(self)
        if self._asys is not None:
            try:
                self._asys.stop()
            except Exception:  # noqa: BLE001
                logger.debug("autoscaler stop failed", exc_info=True)
        err = RuntimeError("fabric router stopped")
        for key, entry in self._table.drain():
            if key[0] == "batch":
                entry["batch"].fail(err)
            else:
                entry["session"]._fail(err)
        for h in self._inqs:
            self._send(h, ("stop",))
        self._sendq.put(None)  # the sender exits once the stops are out
        for t in self._threads:
            if t.name == "tfos-fabric-send":
                t.join(timeout=10)
        launch = [t for t in self._threads if t.name == "tfos-fabric-launch"]
        for t in launch:  # live hosts return on "stop"
            t.join(timeout=15 if self._table.live() else 0.5)
        if self._owns_engine and self._engine is not None:
            self._engine.stop()
            for t in launch:
                t.join(timeout=5)
        if self._mgr is not None:
            try:
                self._mgr.shutdown()
            except Exception:  # noqa: BLE001
                pass

    def _send(self, h, msg):
        """Queue ``msg`` for host ``h``'s inbox (in order)."""
        self._sendq.put((h, msg))

    def _sender(self):
        """The one thread that puts into the hosts' inboxes."""
        while True:
            item = self._sendq.get()
            if item is None:
                return
            h, msg = item
            try:
                self._inqs[h].put(msg)
            except Exception:  # noqa: BLE001 - the manager shut down
                logger.warning("could not send %s to fabric host %d",
                               msg[0], h)

    # -- dispatch ------------------------------------------------------------
    def dispatch(self, batch):
        """Send one batcher Batch to the least-loaded live host (a batch
        mixes unrelated requests: no affinity; the host picks its least
        busy worker)."""
        faults.check("serve.fabric_dispatch", what="batch", id=batch.id)
        if self._job_error is not None and not self._table.live():
            raise RuntimeError(
                f"no fabric hosts left (job failed: {self._job_error})")
        blob = pickle.dumps((batch.inputs, batch.n_valid))
        h = self._table.add(("batch", batch.id),
                            {"batch": batch, "blob": blob})
        metrics_registry.inc("tfos_fabric_dispatches_total", kind="batch")
        self._send(h, ("batch", batch.id, blob))

    def dispatch_session(self, session):
        """Route one decode session: affinity binding, then the ring,
        then least-loaded.  A dead host's sessions re-dispatch to
        survivors (a full re-prefill there) and resolve once."""
        faults.check("serve.fabric_dispatch", what="gen", id=session.id)
        if self.spec.decode is None:
            raise RuntimeError("spec has no decode engine; pass "
                               "ModelSpec(..., decode=DecodeSpec(...))")
        if self._job_error is not None and not self._table.live():
            raise RuntimeError(
                f"no fabric hosts left (job failed: {self._job_error})")
        blob = pickle.dumps({
            "prompt": session.prompt,
            "max_tokens": session.max_tokens,
            "eos_id": session.eos_id,
            "sampling": session.sampling,
            "trace": session.trace,
        })
        route_id = getattr(session, "route_id", None)
        h, rid, outcome = self._route_session(route_id)
        entry = {"session": session, "blob": blob, "rid": rid,
                 "route_id": None if route_id is None else str(route_id),
                 "affinity": outcome}
        owner = self._table.add(("gen", session.id), entry, owner=h)
        metrics_registry.inc("tfos_fabric_dispatches_total", kind="gen")
        if outcome is not None:
            metrics_registry.inc("tfos_fabric_affinity_total",
                                 outcome=outcome)
            with self._lock:
                self._aff[outcome] += 1
                per = self._aff_host.setdefault(
                    owner, {"hit": 0, "miss": 0, "fallback": 0})
                per[outcome] += 1
        self._send(owner, ("gen", session.id, rid, blob))

    def cancel_session(self, sid):
        return self._table.pop(("gen", sid)) is not None

    def outstanding_sessions(self):
        return sum(1 for k in self._table.keys() if k[0] == "gen")

    def _live_workers(self):
        """``{live host: acked worker count}`` (at least 1: a host that
        never acked a scale runs its boot complement)."""
        live = self._table.live()
        with self._lock:
            return {h: max(1, int(self._workers.get(h, 1))) for h in live}

    def _ring_for(self, workers):
        """The ring over live ``(host, worker)`` endpoints, rebuilt only
        when membership or worker counts change."""
        sig = tuple(sorted(workers.items()))
        if sig != self._ring_sig:
            self._ring = Ring([(h, r) for h, n in sorted(workers.items())
                               for r in range(n)])
            self._ring_sig = sig
        return self._ring

    def _saturated(self, h, workers, loads):
        return loads.get(h, 0) >= workers.get(h, 1) * self._sat_load

    def _route_session(self, route_id):
        """``(host, worker hint, outcome)``; ``(None, None, None)`` lets
        the table pick least-loaded (no route id, or nothing live)."""
        faults.check("serve.fabric_route", route=route_id)
        workers = self._live_workers()
        if route_id is None or not workers:
            return None, None, None
        key = str(route_id)
        loads = self._table.loads()
        bound = self._affinity.get(key)
        if bound is not None:
            bh, br = bound
            if (bh in workers and br < workers[bh]
                    and not self._saturated(bh, workers, loads)):
                return bh, br, "hit"
            outcome = "fallback"     # the target is dead, retired or full
        else:
            outcome = "miss"         # first sighting: place on the ring
        h, r = self._ring_for(workers).lookup(key)
        if self._saturated(h, workers, loads):
            cands = [x for x in workers
                     if not self._saturated(x, workers, loads)] or \
                list(workers)
            h = min(cands, key=lambda x: (loads.get(x, 0), x))
            self._rr += 1
            r = self._rr % workers[h]
            outcome = "fallback"
        self._affinity.bind(key, (h, r))
        return h, r, outcome

    # -- version pinning ------------------------------------------------------
    def set_watermark(self, step):
        """Pin the fabric at a blessed version: the latest-wins watcher
        stands down and respawned hosts are steered to it."""
        with self._lock:
            self._watermark = None if step is None else int(step)

    def watermark(self):
        with self._lock:
            return self._watermark

    def reload_watermark(self):
        with self._lock:
            return self._reload_watermark

    def _enforce_version(self, h, version):
        """Steer a host that came up at another version to the pinned
        one: the promotion watermark, else the hot-reload watermark."""
        with self._lock:
            want = (self._watermark if self._watermark is not None
                    else self._reload_watermark)
        if want is not None and version != want:
            self._send(h, ("reload", want))

    def _watch_reload(self):
        """Poll ``utils/checkpoint.latest``; broadcast in-band reloads and
        record the step as the reload watermark respawns converge to."""
        from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

        with self._lock:
            last = max(self._versions.values(), default=0)
        interval = reload_secs_default()
        while not self._stop.wait(interval):
            with self._lock:
                managed = self._watermark is not None
            if managed:
                continue
            try:
                step, _path = ckpt.latest(self.spec.ckpt_dir)
            except Exception:  # noqa: BLE001 - transient fs error
                continue
            if step is None or step == last:
                continue
            last = step
            with self._lock:
                self._reload_watermark = step
            metrics_registry.inc("tfos_serve_reloads_total")
            telemetry.event(telemetry.SERVE_RELOAD, step=step)
            for h in self._table.live():
                self._send(h, ("reload",))

    # -- background threads ---------------------------------------------------
    def _collect(self):
        """Drain the out-queue: registrations, answers, acks."""
        while not self._stop.is_set():
            try:
                msg = self._outq.get(timeout=0.25)
            except _queue.Empty:
                continue
            except Exception:  # noqa: BLE001 - the manager shut down
                return
            try:
                self._handle(msg)
            except Exception:  # noqa: BLE001 - one bad message
                logger.exception("fabric_out message %r failed", msg[:3])

    def _handle(self, msg):
        kind = msg[0]
        if kind == "up":
            _, h, pid, version, n_workers = msg
            respawned = self._table.up(h, pid)
            with self._lock:
                self._versions[h] = version
                self._workers[h] = int(n_workers)
                self.up_times.setdefault(h, []).append(time.monotonic())
            if respawned:
                self.respawns_observed += 1
            self._registered.set()
            telemetry.event("serve/fabric_host_up", host=h, pid=pid,
                            version=version, workers=n_workers)
            self._enforce_version(h, version)
            if respawned:
                # the respawn's up can beat the monitor's death scan
                self._lost(h, "respawned")
                self._redispatch({h})
        elif kind == "down":
            self._table.down(msg[1])
        elif kind == "done":
            _, h, batch_id, payload, meta = msg
            entry = self._table.pop(("batch", batch_id))
            if entry is None:
                return  # a duplicate answer after a re-dispatch
            try:
                entry["batch"].complete(pickle.loads(payload), meta)
            except Exception as e:  # noqa: BLE001
                entry["batch"].fail(e)
        elif kind == "batch_error":
            _, h, batch_id, tb = msg
            entry = self._table.pop(("batch", batch_id))
            if entry is not None:
                entry["batch"].fail(RuntimeError(
                    f"fabric host {h} failed the batch:\n{tb}"))
        elif kind == "gen_token":
            _, h, sid, tindex, tok = msg
            entry = self._table.touch(("gen", sid))
            if entry is not None and not entry["session"]._token(tindex,
                                                                 tok):
                self.replayed_tokens += 1  # a failover replay's duplicate
        elif kind == "gen_done":
            _, h, sid, tokens, meta = msg
            entry = self._table.pop(("gen", sid))
            if entry is None:
                return  # a duplicate answer after a re-dispatch
            meta = dict(meta or {})
            meta["host"] = h
            if entry.get("affinity") is not None:
                meta["affinity"] = entry["affinity"]
            entry["session"]._set(tokens, meta)
        elif kind == "gen_error":
            _, h, sid, err = msg
            entry = self._table.pop(("gen", sid))
            if entry is not None:
                entry["session"]._fail(RuntimeError(
                    f"fabric host {h} failed the decode session: {err}"))
        elif kind == "reloaded":
            with self._lock:
                self._versions[msg[1]] = msg[2]
        elif kind == "scaled":
            _, h, gen, n_workers = msg
            with self._lock:
                self._workers[h] = int(n_workers)
                sent = self._scale_sent.pop(gen, None)
                if sent is not None:
                    self.scale_times.append(
                        (h, int(n_workers), sent[2], time.monotonic()))
        elif kind == "stats":
            self._stats_replies[msg[1]] = msg[2]
            self._stats_event.set()
        elif kind == "init_error":
            logger.warning("fabric host %s reported init_error: %s",
                           msg[1], msg[2])
            errors = self._init_errors
            if errors is not None:
                errors[msg[1]] = msg[2]
                self._registered.set()

    def _lost(self, h, why):
        with self._lock:
            self.lost_times.setdefault(h, []).append(time.monotonic())
        telemetry.event("serve/fabric_host_lost", host=h, reason=why)

    def _monitor(self):
        """Death and staleness, plan actuation, load publishing."""
        while not self._stop.wait(0.2):
            now = time.monotonic()
            dead = liveness.scan(self._table.live(), self._proc_alive,
                                 self._beat_age, liveness.stale_after())
            for h, why in dead:
                self._table.lost(h)
                logger.warning("fabric host %d lost (%s); re-dispatching "
                               "its in-flight envelopes", h, why)
                self._lost(h, why)
            if dead:
                self._redispatch({h for h, _ in dead})
            for key, entry in self._table.stale(self._request_timeout, now):
                if key[0] == "batch":
                    entry["batch"].fail(TimeoutError(
                        "batch not answered within "
                        f"{self._request_timeout}s"))
                else:
                    entry["session"]._fail(TimeoutError(
                        "decode session streamed no token within "
                        f"{self._request_timeout}s"))
            try:
                self._apply_plan()
            except Exception:  # noqa: BLE001 - the next pass retries
                logger.debug("plan application failed", exc_info=True)
            self._publish_load(now)

    def _apply_plan(self):
        """Actuate the autoscaler's newest plan (``fabric:plan``) as
        generation-fenced scale directives."""
        if self._mgr is None:
            return
        try:
            plan = self._mgr.get(_host.PLAN_KEY)
        except Exception:  # noqa: BLE001 - the manager is tearing down
            return
        if not isinstance(plan, dict):
            return
        seq = int(plan.get("seq", 0))
        if seq <= self._plan_applied:
            return
        self._plan_applied = seq
        live = set(self._table.live())
        for hs, n in (plan.get("hosts") or {}).items():
            h, n = int(hs), int(n)
            if h not in live:
                continue
            with self._lock:
                cur = self._workers.get(h)
            if cur is None or n == cur:
                continue
            direction = "up" if n > cur else "down"
            if direction == "up":
                self.scale_ups += 1
            else:
                self.scale_downs += 1
            self._gen += 1
            with self._lock:
                self._scale_sent[self._gen] = (h, n, time.monotonic())
            metrics_registry.inc("tfos_fabric_scale_events_total",
                                 direction=direction)
            telemetry.event("serve/fabric_scale", host=h,
                            direction=direction, workers=n, seq=seq)
            logger.info("fabric scale %s: host %d %d -> %d workers",
                        direction, h, cur, n)
            self._send(h, ("scale", self._gen, n))

    def _publish_load(self, now):
        """Each host's ``{workers, depth}`` to the manager KV (the
        autoscaler's signal) and the fabric gauges."""
        if now - self._last_pub < 0.5:
            return
        self._last_pub = now
        workers = self._live_workers()
        loads = self._table.loads()
        doc = {"ts": time.time(),
               "hosts": {str(h): {"workers": w,
                                  "depth": int(loads.get(h, 0))}
                         for h, w in workers.items()}}
        try:
            self._mgr.set(_host.LOAD_KEY, doc)
        except Exception:  # noqa: BLE001 - the manager is tearing down
            pass
        metrics_registry.set_gauge("tfos_fabric_hosts", len(workers))
        metrics_registry.set_gauge("tfos_fabric_replicas",
                                   sum(workers.values()))
        metrics_registry.set_gauge("tfos_fabric_queue_depth",
                                   len(self._table))

    def _redispatch(self, dead_hosts):
        """Re-send a dead host's in-flight envelopes to survivors.  A
        session re-prefills on the survivor's worker 0 and its route is
        rebound there, so its next turn follows its blocks."""
        moved = {"batch": 0, "gen": 0}
        for key in self._table.owned_by(dead_hosts):
            h = self._table.reassign(key)
            entry = self._table.get(key)
            if h is None or entry is None:
                continue
            if key[0] == "batch":
                self._send(h, ("batch", key[1], entry["blob"]))
            else:
                entry["rid"] = 0
                if entry.get("route_id") is not None:
                    self._affinity.bind(entry["route_id"], (h, 0))
                self._send(h, ("gen", key[1], 0, entry["blob"]))
            metrics_registry.inc("tfos_fabric_redispatches_total",
                                 kind=key[0])
            moved[key[0]] += 1
            self.redispatched += 1
        if moved["batch"] or moved["gen"]:
            telemetry.event("serve/fabric_redispatch",
                            batches=moved["batch"], sessions=moved["gen"],
                            to=self._table.live())

    def _proc_alive(self, h):
        procs = getattr(self._engine, "_procs", None)
        if not procs:
            return True  # a foreign engine: no process visibility
        try:
            return procs[h % len(procs)].is_alive()
        except Exception:  # noqa: BLE001
            return True

    def _beat_age(self, h):
        return liveness.beat_age(self._mgr, _host.HEARTBEAT_PREFIX + str(h))

    # -- introspection --------------------------------------------------------
    def live_replicas(self):
        return self._table.live()

    def replica_pids(self):
        return self._table.pids()

    def host_pids(self):
        return self._table.pids()

    def versions(self):
        with self._lock:
            return dict(self._versions)

    def affinity_binding(self, route_id):
        """The ``(host, worker)`` a route is bound to, or None."""
        return self._affinity.get(str(route_id))

    def affinity_counts(self):
        with self._lock:
            return dict(self._aff)

    def stats(self, timeout=10.0):
        """Broadcast a stats request; gather each host's rollup (its
        workers' predictor and decode stats by worker id, and the host's
        kernel launches)."""
        targets = self._table.live()
        self._stats_replies = {}
        self._stats_event.clear()
        for h in targets:
            self._send(h, ("stats",))
        deadline = time.monotonic() + timeout
        while (set(self._stats_replies) < set(targets)
               and time.monotonic() < deadline):
            self._stats_event.wait(0.1)
            self._stats_event.clear()
        return dict(self._stats_replies)

    def describe(self):
        """The summary and a row a host (/statusz's pods section)."""
        live = set(self._table.live())
        loads = self._table.loads()
        pids = self._table.pids()
        with self._lock:
            workers = dict(self._workers)
            versions = dict(self._versions)
            aff = {h: dict(v) for h, v in self._aff_host.items()}
            aff_total = dict(self._aff)
        hosts = []
        for h in range(self.num_hosts):
            a = aff.get(h, {})
            total = sum(a.values())
            hosts.append({
                "host": h,
                "alive": h in live,
                "pid": pids.get(h),
                "replicas": int(workers.get(h, 0)) if h in live else 0,
                "queue_depth": int(loads.get(h, 0)),
                "version": versions.get(h),
                "affinity_hit_rate": (round(a.get("hit", 0) / total, 4)
                                      if total else None),
            })
        return {
            "fabric": True,
            "num_hosts": self.num_hosts,
            "live_hosts": len(live),
            "replicas": sum(int(workers.get(h, 0)) for h in live),
            "autoscale": bool(self._autoscale),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "redispatched": self.redispatched,
            "respawns": self.respawns_observed,
            "affinity": aff_total,
            "hosts": hosts,
        }
