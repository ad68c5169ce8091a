"""Supervised-actor runtime: spawn, mailboxes, liveness, failover.

An own copy of ``tensorflowonspark_tpu/actors/runtime.py``.  An
:class:`Actor` subclass defines behaviour (``on_start``,
``on_message``, ``on_tick``, ``on_stop``); an :class:`ActorSystem`
places N members of it on ``LocalEngine`` executor slots and supervises
them:

- **spawn and respawn** ride the engine's retryable tasks
  (``foreach_partition(placement=..., retryable=True)``): a SIGKILLed
  member's executor is respawned and its task re-dispatched byte for
  byte, as the serving replicas' are.
- **liveness** is the keyed manager-KV heartbeat (``actors.liveness``)
  plus the executor process's own liveness; a wedged member (beats
  stopped, process alive) is killed so that the engine takes over.
- **mailboxes** are manager queues in the ``actors.mailbox`` grammar:
  bounded ``tell`` and ``ask`` with epoch fencing; replies resolve
  :class:`~tensorflowonspark_tpu_torch.actors.ledger.ResolveOnce`
  futures, so an ask answered twice after a re-dispatch resolves once.
- **policy** is declarative, a group
  (:class:`~tensorflowonspark_tpu_torch.actors.policy.SupervisionPolicy`).
- **fault injection**: the ``TFOS_FAULT_PLAN`` sites ``actor.spawn``,
  ``actor.receive`` and ``actor.tick`` fire inside the member's loop.

As everywhere in the port, what crosses a process is pickled with plain
pickle: an actor is an instance of a module-level class whose state
pickles, and the member task is the module-level :class:`_actor_task`.
The runtime touches no CUDA.  An actor's own code may (the eval
sidecar's ``eval_fn`` on the card, a sweep's trials): its executor then
holds a CUDA context and must fork no trainer, so such actors get an
``ActorSystem`` of their own.
"""

from __future__ import annotations

import logging
import os
import pickle
import queue as _queue
import signal
import threading
import time
import traceback
import weakref

from tensorflowonspark_tpu_torch import manager as tfmanager
from tensorflowonspark_tpu_torch.actors import ledger as _ledger
from tensorflowonspark_tpu_torch.actors import liveness, mailbox
from tensorflowonspark_tpu_torch.actors.dispatch import InFlightTable
from tensorflowonspark_tpu_torch.actors.policy import SupervisionPolicy
from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)

__all__ = ["Actor", "ActorContext", "ActorSystem", "ActorGroup",
           "AskFuture", "EchoActor", "actor_table"]


class Actor:
    """Behaviour of one supervised member.  Subclass at module level
    and override; the instance is pickled to every member, so keep its
    state picklable (each member's diverges after spawn)."""

    def on_start(self, ctx):
        """Runs once per incarnation, before the mailbox loop."""

    def on_message(self, ctx, kind, payload):
        """Handle one ``tell``/``ask`` envelope; the return value is the
        ask reply.  May be re-invoked for the same logical message after
        a failover (at-least-once); use ``ctx.ledger`` for exactly-once
        effects."""
        raise NotImplementedError(f"unhandled message kind {kind!r}")

    def on_tick(self, ctx):
        """Runs when the mailbox is idle for ``policy.tick_secs``."""

    def on_stop(self, ctx):
        """Runs on clean shutdown (never on SIGKILL — by definition)."""


class ActorContext:
    """What a running member sees: identity, the manager KV, and an
    exactly-once ledger surviving its own death."""

    __slots__ = ("group", "index", "epoch", "mgr", "ledger", "_outq")

    def __init__(self, group, index, epoch, mgr, outq):
        self.group = group
        self.index = index
        self.epoch = epoch
        self.mgr = mgr
        #: KV-backed exactly-once ledger namespaced by group: an effect
        #: recorded here is skipped by every later incarnation.
        self.ledger = _ledger.KVLedger(mgr, group)
        self._outq = outq

    def kv_get(self, key):
        return self.mgr.get(f"actor_kv:{self.group}:{key}")

    def kv_set(self, key, value):
        self.mgr.set(f"actor_kv:{self.group}:{key}", value)

    def emit(self, kind, payload=None):
        """Unsolicited notification to the driver (group ``events``)."""
        self._outq.put(("event", self.index, kind,
                        pickle.dumps(payload)))


class EchoActor(Actor):
    """Test/bench actor: echoes asks; ``pid``/``sleep``/``crash`` kinds
    exercise identity, slowness and SIGKILL-failover paths."""

    def __init__(self):
        self.ticks = 0

    def on_tick(self, ctx):
        self.ticks += 1

    def on_message(self, ctx, kind, payload):
        if kind == "pid":
            return os.getpid()
        if kind == "sleep":
            time.sleep(float(payload))
            return payload
        if kind == "crash":
            os.kill(os.getpid(), signal.SIGKILL)
        if kind == "ticks":
            return self.ticks
        return payload


class _actor_task:  # noqa: N801 - an engine task, named as the JAX closure
    """The engine task every member runs: connect to the system's
    manager, boot the actor (fencing the previous incarnation's mail by
    the epoch in the KV), beat, and serve the mailbox until ``stop``."""

    def __init__(self, actor_blob, policy_blob, group, mgr_addr,
                 mgr_authkey):
        self.actor_blob = actor_blob
        self.policy_blob = policy_blob
        self.group = group
        self.mgr_addr = tuple(mgr_addr)
        self.mgr_authkey = mgr_authkey

    def __call__(self, it):
        group = self.group
        items = list(it)
        idx = int(os.environ.get(
            "TFOS_PARTITION_INDEX", items[0] if items else 0))
        mgr = tfmanager.connect(self.mgr_addr, self.mgr_authkey)
        inq = mgr.get_queue(mailbox.in_queue(group, idx))
        outq = mgr.get_queue(mailbox.out_queue(group))
        telemetry.configure(node_id=f"actor-{group}-{idx}", role="actor")
        try:
            faults.check("actor.spawn", group=group, actor=idx)
            actor = pickle.loads(self.actor_blob)
            policy = pickle.loads(self.policy_blob)
            # the boot epoch fences the previous incarnation's inherited
            # mail: the supervisor bumps the KV before this respawn, so
            # envelopes stamped older than it are the dead twin's
            epoch = int(mgr.get(mailbox.epoch_key(group, idx)) or 0)
            ctx = ActorContext(group, idx, epoch, mgr, outq)
            actor.on_start(ctx)
        except BaseException as e:  # noqa: BLE001 - report, then fail task
            outq.put(("init_error", idx, repr(e)))
            raise
        stop_beat = liveness.start_heartbeat(
            mgr, mailbox.beat_key(group, idx), policy.heartbeat_secs)
        outq.put(("up", idx, os.getpid(), epoch))
        try:
            _serve_mailbox(actor, ctx, policy, inq, outq)
        finally:
            stop_beat.set()
            try:
                actor.on_stop(ctx)
            except Exception:  # noqa: BLE001 - teardown
                logger.exception("actor %s[%d] on_stop failed", group, idx)
            outq.put(("down", idx))
            telemetry.flush()


def _serve_mailbox(actor, ctx, policy, inq, outq):
    """One member's mailbox loop: ticks when idle, tells and asks with
    epoch fencing, until ``stop``."""
    group, idx, epoch = ctx.group, ctx.index, ctx.epoch
    while True:
        try:
            msg = inq.get(timeout=policy.tick_secs)
        except _queue.Empty:
            faults.check("actor.tick", group=group, actor=idx)
            try:
                actor.on_tick(ctx)
            except Exception:  # noqa: BLE001 - a tick must not kill
                logger.exception("actor %s[%d] on_tick failed", group, idx)
                outq.put(("event", idx, "tick_error",
                          pickle.dumps(traceback.format_exc())))
            continue
        kind = msg[0]
        if kind == "stop":
            break
        if kind == "tell":
            # the trailing trace element is optional (mailbox grammar)
            m_epoch, m_kind, blob = msg[1], msg[2], msg[3]
            m_trace = msg[4] if len(msg) > 4 else None
            if policy.epoch_fencing and m_epoch < epoch:
                continue  # the dead incarnation's inherited mail
            try:
                faults.check("actor.receive", group=group, actor=idx,
                             msg=m_kind)
                with telemetry.activate(m_trace), \
                        telemetry.span(telemetry.ACTOR_MESSAGE, group=group,
                                       actor=idx, kind=m_kind, ask=False):
                    actor.on_message(ctx, m_kind, pickle.loads(blob))
            except Exception:  # noqa: BLE001 - one bad tell must not take
                # the member down
                logger.exception("actor %s[%d] failed tell %r", group, idx,
                                 m_kind)
                outq.put(("event", idx, "tell_error",
                          pickle.dumps(traceback.format_exc())))
        elif kind == "ask":
            m_epoch, req_id, m_kind, blob = msg[1:5]
            m_trace = msg[5] if len(msg) > 5 else None
            if policy.epoch_fencing and m_epoch < epoch:
                # fenced: the supervisor re-stamped and re-sent a copy
                continue
            try:
                faults.check("actor.receive", group=group, actor=idx,
                             msg=m_kind)
                with telemetry.activate(m_trace), \
                        telemetry.span(telemetry.ACTOR_MESSAGE, group=group,
                                       actor=idx, kind=m_kind, ask=True):
                    out = actor.on_message(ctx, m_kind, pickle.loads(blob))
                outq.put(("reply", idx, req_id, True, pickle.dumps(out)))
            except BaseException:  # noqa: BLE001 - the asker gets the
                # traceback; the member keeps serving
                outq.put(("reply", idx, req_id, False,
                          pickle.dumps(traceback.format_exc())))


class AskFuture(_ledger.ResolveOnce):
    """A pending ask reply.  ``result(timeout)`` blocks; re-dispatched
    asks answered by two incarnations resolve exactly once."""

    __slots__ = ("req_id",)

    def __init__(self, req_id):
        super().__init__()
        self.req_id = req_id

    def result(self, timeout=60.0):
        return self.wait(timeout, "actor reply not delivered")


class ActorGroup:
    """N supervised members of one actor class.  Created by
    :meth:`ActorSystem.spawn`; the driver-facing handle."""

    def __init__(self, system, name, actor, count, policy, slots):
        self.name = name
        self.count = count
        self.policy = policy
        self.slots = list(slots)          # member idx -> engine slot
        self._system = system
        self._mgr = system._mgr
        self._inqs = {i: self._mgr.get_queue(mailbox.in_queue(name, i))
                      for i in range(count)}
        self._outq = self._mgr.get_queue(mailbox.out_queue(name))
        self._table = InFlightTable(count)
        self._epochs = {i: 0 for i in range(count)}
        self._epoch_lock = threading.Lock()
        self._req_counter = 0
        self._registered = threading.Event()
        self._stop = threading.Event()
        self._job_error = None
        self._init_errors = []
        self.events = []                  # [(idx, kind, payload)] tail
        self.spawns_observed = 0
        self.respawns_observed = 0
        self._threads = []
        blob = pickle.dumps(actor)
        pblob = pickle.dumps(policy)
        self._task = _actor_task(
            blob, pblob, name, tuple(self._mgr.address), system._authkey)

    # -- lifecycle -----------------------------------------------------------
    def _start(self, timeout):
        def _launch():
            try:
                ds = self._system._engine.parallelize(
                    list(range(self.count)), self.count)
                ds.foreach_partition(
                    self._task, placement=self.slots, retryable=True,
                    max_retries=self.policy.respawns)
            except BaseException as e:  # noqa: BLE001 - surfaced below
                self._job_error = e
                logger.error("actor group %s job failed: %s", self.name, e)

        for name, target in ((f"tfos-actors-{self.name}-launch", _launch),
                             (f"tfos-actors-{self.name}-collect",
                              self._collect),
                             (f"tfos-actors-{self.name}-monitor",
                              self._monitor)):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._job_error is not None:
                raise RuntimeError(
                    f"actor group {self.name} failed to start: "
                    f"{self._job_error}")
            if self._init_errors:
                raise RuntimeError(
                    f"actor group {self.name} failed to start: "
                    f"{self._init_errors[0]}")
            if len(self._table.live()) >= self.count:
                return self
            self._registered.wait(0.2)
            self._registered.clear()
        raise TimeoutError(
            f"actor group {self.name} not up within {timeout}s "
            f"({len(self._table.live())}/{self.count})")

    def stop(self):
        if self._stop.is_set():
            return
        self._stop.set()
        err = RuntimeError(f"actor group {self.name} stopped")
        for _key, entry in self._table.drain():
            entry["future"].reject(err)
        for inq in self._inqs.values():
            try:
                inq.put(("stop",))
            except Exception:  # noqa: BLE001 - manager may be gone
                pass
        for t in self._threads:
            if t.name.endswith("-launch"):
                t.join(timeout=15)

    # -- messaging -----------------------------------------------------------
    def _pick(self, index):
        if index is not None:
            return int(index)
        live = self._table.live() or list(range(self.count))
        loads = self._table.loads()
        return min(live, key=lambda i: (loads.get(i, 0), i))

    def _send(self, idx, envelope):
        depth = mailbox.checked_put(
            self._inqs[idx], mailbox.in_queue(self.name, idx), envelope,
            self.policy.mailbox_depth)
        metrics_registry.set_gauge("tfos_actor_mailbox_depth", depth,
                                   group=self.name)

    def tell(self, kind, payload=None, index=None):
        """One-way send to ``index`` (default: least-loaded live member).
        Raises :class:`~.mailbox.MailboxFull` past the depth bound."""
        self._raise_if_dead()
        idx = self._pick(index)
        with self._epoch_lock:
            epoch = self._epochs[idx]
        ctx = telemetry.current()
        self._send(idx, ("tell", epoch, kind, pickle.dumps(payload),
                         ctx.to_header() if ctx is not None else None))
        return idx

    def ask(self, kind, payload=None, index=None):
        """Request/reply: returns an :class:`AskFuture`.  A member lost
        mid-flight gets its asks re-dispatched to survivors (or
        re-stamped for its own respawn); the future resolves once."""
        self._raise_if_dead()
        blob = pickle.dumps(payload)
        ctx = telemetry.current()
        trace = ctx.to_header() if ctx is not None else None
        with self._epoch_lock:
            self._req_counter += 1
            req_id = self._req_counter
        future = AskFuture(req_id)
        idx = self._table.add(
            req_id, {"future": future, "kind": kind, "blob": blob,
                     "trace": trace},
            owner=(None if index is None else int(index)))
        with self._epoch_lock:
            epoch = self._epochs[idx]
        try:
            self._send(idx, ("ask", epoch, req_id, kind, blob, trace))
        except BaseException:
            self._table.pop(req_id)
            raise
        return future

    def broadcast(self, kind, payload=None):
        """Tell every live member; returns the indices reached."""
        reached = []
        for idx in self._table.live():
            try:
                self.tell(kind, payload, index=idx)
                reached.append(idx)
            except mailbox.MailboxFull:
                pass
        return reached

    def _raise_if_dead(self):
        if self._job_error is not None and not self._table.live():
            raise RuntimeError(
                f"actor group {self.name} has no members left "
                f"(job failed: {self._job_error})")

    # -- background threads ---------------------------------------------------
    def _collect(self):
        """Drain the group out-queue: registrations, replies, events."""
        while not self._stop.is_set():
            try:
                msg = self._outq.get(timeout=0.25)
            except _queue.Empty:
                continue
            except Exception:  # noqa: BLE001 - manager shut down
                return
            kind = msg[0]
            if kind == "up":
                _, idx, pid, epoch = msg
                respawned = self._table.up(idx, pid)
                self.spawns_observed += 1
                metrics_registry.inc("tfos_actor_spawns_total",
                                     group=self.name)
                self._registered.set()
                telemetry.event("actor/up", group=self.name, actor=idx,
                                pid=pid, epoch=epoch)
                if respawned:
                    # A respawn can beat the monitor's death poll — in
                    # that ordering the lost-path never ran, the epoch
                    # was never bumped, and the dead incarnation would
                    # stay unfenced forever.  Fence here too: future
                    # mail and the redispatch below carry a NEWER epoch
                    # (fencing drops only envelopes older than a
                    # member's boot epoch, so the live member keeps
                    # accepting; when the scan did win this is a second
                    # bump, which is harmless for the same reason).
                    with self._epoch_lock:
                        self._epochs[idx] += 1
                        fence = self._epochs[idx]
                    try:
                        self._mgr.set(mailbox.epoch_key(self.name, idx),
                                      fence)
                    except Exception:  # noqa: BLE001 - manager teardown
                        pass
                    self.respawns_observed += 1
                    metrics_registry.inc("tfos_actor_respawns_total",
                                         group=self.name)
                    telemetry.event("actor/respawn", group=self.name,
                                    actor=idx, pid=pid, epoch=epoch)
                    # This is the authoritative failover trigger: the
                    # dead incarnation's popped asks are gone; queued
                    # ones will at worst be answered twice (futures
                    # resolve once).  Re-dispatch everything it owned.
                    self._redispatch({idx})
            elif kind == "reply":
                _, idx, req_id, ok, blob = msg
                entry = self._table.pop(req_id)
                if entry is None:
                    continue  # duplicate answer after a re-dispatch
                try:
                    value = pickle.loads(blob)
                except Exception as e:  # noqa: BLE001
                    entry["future"].reject(e)
                    continue
                if ok:
                    entry["future"].resolve(value)
                else:
                    entry["future"].reject(RuntimeError(
                        f"actor {self.name}[{idx}] failed "
                        f"{entry['kind']!r}:\n{value}"))
            elif kind == "event":
                _, idx, ekind, blob = msg
                try:
                    payload = pickle.loads(blob)
                except Exception:  # noqa: BLE001
                    payload = None
                self.events.append((idx, ekind, payload))
                del self.events[:-256]
            elif kind == "init_error":
                self._init_errors.append(msg[2])
                logger.warning("actor %s[%s] init_error: %s",
                               self.name, msg[1], msg[2])
            elif kind == "down":
                self._table.down(msg[1])

    def _monitor(self):
        """Liveness sweep: engine-process death (fast path) and stale KV
        heartbeats (wedged-member path).  A wedged member is killed so
        the engine's respawn machinery takes over; either way the epoch
        is bumped (fencing its inherited mail) and its in-flight asks
        re-dispatched."""
        while not self._stop.wait(0.2):
            live = self._table.live()
            lost = liveness.scan(
                live, self._proc_alive,
                lambda i: liveness.beat_age(
                    self._mgr, mailbox.beat_key(self.name, i)),
                self.policy.stale_secs)
            ages = [liveness.beat_age(self._mgr,
                                      mailbox.beat_key(self.name, i))
                    for i in live]
            known = [a for a in ages if a is not None]
            if known and metrics_registry.enabled():
                metrics_registry.set_gauge("tfos_actor_heartbeat_age_s",
                                           max(known), group=self.name)
            for idx, why in lost:
                self._table.lost(idx)
                with self._epoch_lock:
                    self._epochs[idx] += 1
                    epoch = self._epochs[idx]
                try:
                    self._mgr.set(mailbox.epoch_key(self.name, idx), epoch)
                except Exception:  # noqa: BLE001 - manager tearing down
                    pass
                telemetry.event("actor/lost", group=self.name, actor=idx,
                                reason=why, epoch=epoch)
                logger.warning("actor %s[%d] lost (%s); epoch -> %d",
                               self.name, idx, why, epoch)
                try:  # black-box flight dump (docs/telemetry.md)
                    from tensorflowonspark_tpu_torch.obs import flight as _flight

                    _flight.snapshot(
                        "actor/lost", node=f"{self.name}[{idx}]",
                        reason=why, inflight=self._inflight_summary())
                except Exception:  # noqa: BLE001 - never block failover
                    logger.debug("flight snapshot failed", exc_info=True)
                if "stale" in why:
                    # wedged, not dead: kill it so engine supervision
                    # respawns the slot (process death is the signal the
                    # engine acts on)
                    pid = self._table.pids().get(idx)
                    if pid:
                        try:
                            os.kill(pid, signal.SIGKILL)
                        except OSError:
                            pass
            if lost:
                self._redispatch({idx for idx, _ in lost})
            # request-timeout sweep: fail asks stuck past the deadline
            # (None by default: asks wait at the future)
            timeout = getattr(self.policy, "request_timeout", None)
            for _key, entry in self._table.stale(timeout):
                entry["future"].reject(TimeoutError(
                    f"ask not answered within {timeout}s"))

    def _inflight_summary(self, limit=32):
        """Small-scalar view of outstanding asks for flight dumps —
        ids, kinds and trace headers only, never payload blobs
        (redaction contract, docs/telemetry.md "Flight recorder")."""
        out = []
        for req_id in list(self._table.keys())[:limit]:
            entry = self._table.get(req_id)
            if entry is None:
                continue
            item = {"req_id": req_id, "kind": str(entry.get("kind"))}
            if entry.get("trace"):
                item["trace"] = entry["trace"]
            out.append(item)
        return out

    def _redispatch(self, dead_idxs):
        """Re-dispatch asks owned by ``dead_idxs``: to the least-loaded
        survivor, or — when none is live — re-stamped into the dead
        member's own mailbox for its respawn (the bumped epoch fences
        the inherited duplicate)."""
        moved = 0
        for req_id in self._table.owned_by(dead_idxs):
            entry = self._table.get(req_id)
            if entry is None:
                continue
            old = entry["owner"]
            idx = self._table.reassign(req_id)
            if idx is None:
                idx = old
            with self._epoch_lock:
                epoch = self._epochs[idx]
            try:
                self._inqs[idx].put(
                    ("ask", epoch, req_id, entry["kind"], entry["blob"],
                     entry.get("trace")))
                moved += 1
            except Exception:  # noqa: BLE001 - manager tearing down
                pass
        if moved:
            telemetry.event("actor/redispatch", group=self.name,
                            asks=moved, dead=sorted(dead_idxs))

    def _proc_alive(self, idx):
        procs = getattr(self._system._engine, "_procs", None)
        slot = self.slots[idx]
        if procs is None or slot >= len(procs):
            return True  # foreign engine: no process visibility
        try:
            return procs[slot].is_alive()
        except Exception:  # noqa: BLE001
            return True

    # -- introspection ---------------------------------------------------------
    def live(self):
        return self._table.live()

    def pids(self):
        return self._table.pids()

    def epochs(self):
        with self._epoch_lock:
            return dict(self._epochs)

    def outstanding(self):
        return len(self._table)

    def rows(self):
        """Status rows for ``/statusz`` (one per member)."""
        live = set(self._table.live())
        pids = self._table.pids()
        loads = self._table.loads()
        epochs = self.epochs()
        out = []
        for i in range(self.count):
            age = liveness.beat_age(self._mgr,
                                    mailbox.beat_key(self.name, i))
            out.append({
                "group": self.name, "actor": i,
                "live": i in live, "pid": pids.get(i),
                "epoch": epochs.get(i, 0),
                "in_flight": loads.get(i, 0),
                "beat_age_s": None if age is None else round(age, 1),
            })
        return out


class ActorSystem:
    """Owns the engine slots, the IPC manager and every group spawned
    through it.  ``capacity`` is the executor-slot count; groups take
    slots in spawn order."""

    def __init__(self, capacity, engine=None, env=None):
        if engine is None:
            from tensorflowonspark_tpu_torch.engine import LocalEngine

            engine = LocalEngine(int(capacity), env=dict(env) if env else None)
            self._owns_engine = True
        else:
            self._owns_engine = False
        self._engine = engine
        self.capacity = int(capacity)
        self._authkey = os.urandom(16)
        self._mgr = tfmanager.start(self._authkey, [])
        self._groups = {}
        self._next_slot = 0
        self._stopped = False
        _SYSTEMS.add(self)

    def spawn(self, actor, name, count=1, policy=None, timeout=120.0):
        """Place ``count`` members of ``actor`` on the next free slots;
        blocks until all are up.  Returns the :class:`ActorGroup`."""
        if name in self._groups:
            raise ValueError(f"actor group {name!r} already exists")
        count = int(count)
        if self._next_slot + count > self.capacity:
            raise ValueError(
                f"cannot spawn {count} member(s) of {name!r}: "
                f"{self.capacity - self._next_slot} of {self.capacity} "
                "slots free")
        slots = list(range(self._next_slot, self._next_slot + count))
        self._next_slot += count
        group = ActorGroup(self, name, actor,
                           count, policy or SupervisionPolicy(), slots)
        self._groups[name] = group
        return group._start(timeout)

    def group(self, name):
        return self._groups[name]

    def groups(self):
        return dict(self._groups)

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        for group in self._groups.values():
            group.stop()
        if self._owns_engine:
            self._engine.stop()
        try:
            self._mgr.shutdown()
        except Exception:  # noqa: BLE001
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


#: Live systems, for /statusz introspection (obs/http.actor rows).
_SYSTEMS = weakref.WeakSet()


def actor_table():
    """Status rows for every member of every live :class:`ActorSystem`
    (the ``/statusz`` actor table)."""
    rows = []
    for system in list(_SYSTEMS):
        if system._stopped:
            continue
        for group in system.groups().values():
            try:
                rows.extend(group.rows())
            except Exception:  # noqa: BLE001 - system tearing down
                continue
    return sorted(rows, key=lambda r: (r["group"], r["actor"]))
