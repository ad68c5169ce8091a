"""Fabric host: one engine executor running N replica worker threads.

An own copy of ``tensorflowonspark_tpu/serving/fabric/host.py``.  Its
shape is :class:`~tensorflowonspark_tpu_torch.serving.replicas._ReplicaTask`'s
(a module-level task class shipped by plain pickle, manager queues for
transport, a keyed KV heartbeat, an in-band message loop) with one more
level of fan-out: the host's loop routes envelopes onto worker thread
inboxes, and each :class:`_Worker` owns its own ``_Predictor`` and, when
the spec mounts decode, its own ``DecodeEngine`` on the host's device.
So a host with 3 workers holds 3 KV caches, which is what makes
affinity routing (``router.py``) pay.

On the card every worker of a host runs on one device and one CUDA
context, on the default stream.  The kernels' launch counts are the
process's: a host reports them once (``stats()["launches"]``), beside
each worker's own prefills and prefix hits, and zeroes them at boot.

Wire (host->driver messages lead with the host index; workers are a
host-local detail and the driver's dispatch table is keyed by host):

- driver->host (``fabric_in_<h>``): ``("batch", bid, blob)``,
  ``("gen", sid, rid, blob)`` (``rid``: the worker affinity picked, None
  = the host's least busy), ``("reload"[, step])``, ``("scale", gen,
  n)`` (generation-fenced), ``("stats",)``, ``("stop",)``.
- host->driver (``fabric_out``): ``("up", h, pid, version, workers)``,
  ``("down", h)``, ``("done", h, bid, blob, meta)``,
  ``("batch_error", h, bid, tb)``, ``("gen_token", h, sid, i, tok)``,
  ``("gen_done", h, sid, tokens, meta)``, ``("gen_error", h, sid,
  err)``, ``("reloaded", h, version)``, ``("scaled", h, gen, n)``,
  ``("stats", h, st)``, ``("init_error", h, err)``.

A scale-down retires the highest worker ids first: a retiring worker
stops admitting, drains its inbox in order, waits out its live decode
sessions, then stops its engine, so it drops no request.
"""

from __future__ import annotations

import logging
import os
import pickle
import queue as _queue
import threading
import time
import traceback

from tensorflowonspark_tpu_torch import manager as tfmanager
from tensorflowonspark_tpu_torch.actors import liveness
from tensorflowonspark_tpu_torch.serving.replicas import (
    _decode_params,
    _maybe_reload,
    _resolve_predictor,
)
from tensorflowonspark_tpu_torch.utils import telemetry

logger = logging.getLogger(__name__)

OUT_QUEUE = "fabric_out"
HEARTBEAT_PREFIX = "fabric_heartbeat:"
ENDPOINT_KEY = "fabric:ep:"     # + host index -> {"pid", "workers", ...}
LOAD_KEY = "fabric:load"        # the router's per-host load rollup
PLAN_KEY = "fabric:plan"        # the autoscaler's worker plan

RETIRE_GRACE_S = 30.0


def _in_queue(h):
    return f"fabric_in_{h}"


class _Worker:
    """One replica: a thread owning a predictor and, optionally, a
    decode engine.  ``load()`` (queued envelopes, the one in hand and
    live sessions) breaks ties within a host; the driver keeps each
    host's load in its dispatch table."""

    def __init__(self, host, rid, payload, device, outq):
        self.host = host
        self.rid = rid
        self.payload = payload
        self.device = device
        self.outq = outq
        self.inbox = _queue.Queue()
        self.accepting = True
        self.ready = threading.Event()
        self.error = None
        self.pred = None
        self.engine = None
        self._pending = 0
        self._sessions = 0
        self._lock = threading.Lock()
        self.thread = threading.Thread(
            target=self._run, name=f"fabric-worker-{host}-{rid}", daemon=True)

    def start(self):
        self.thread.start()
        return self

    def push(self, msg):
        with self._lock:
            self._pending += 1
        self.inbox.put(msg)

    def retire(self):
        """Stop admitting; the ``retire`` marker is handled after what
        the inbox already holds (an in-band, ordered drain)."""
        self.accepting = False
        self.inbox.put(("retire",))

    def load(self):
        with self._lock:
            return self._pending + self._sessions

    def version(self):
        pred = self.pred
        return pred.version if pred is not None else None

    def stats(self):
        pred, engine = self.pred, self.engine
        st = pred.stats() if pred is not None else {}
        if engine is not None:
            st["decode"] = engine.stats()
        st["load"] = self.load()
        st["accepting"] = self.accepting
        return st

    def _emit(self, kind, sid, *rest):
        if kind in ("done", "error"):
            with self._lock:
                self._sessions = max(0, self._sessions - 1)
        if kind == "done":  # the worker and the version that retired it
            rest = (rest[0], dict(rest[1], worker=self.rid,
                                  version=self.version()))
        self.outq.put(("gen_" + kind, self.host, sid) + tuple(rest))

    def _decode_params(self, pred):
        return _decode_params(pred.params, self.payload["decode"].cfg)

    def _run(self):
        try:
            pred = _resolve_predictor(self.payload, self.device)
            engine = None
            if self.payload.get("decode") is not None:
                from tensorflowonspark_tpu_torch.serving.decode.scheduler \
                    import DecodeEngine

                engine = DecodeEngine(
                    self._decode_params(pred), self.payload["decode"],
                    self._emit, replica=self.rid, device=self.device,
                    jit=self.payload.get("jit")).start()
        except BaseException as e:  # noqa: BLE001 - report, stay down
            self.error = e
            self.accepting = False
            self.ready.set()
            return
        self.pred = pred
        self.engine = engine
        self.ready.set()
        try:
            while True:
                msg = self.inbox.get()
                kind = msg[0]
                if kind == "retire":
                    break
                try:
                    self._handle(kind, msg, pred, engine)
                except Exception as e:  # noqa: BLE001 - one bad envelope
                    # must not take the worker down
                    if kind == "batch":
                        self.outq.put(("batch_error", self.host, msg[1],
                                       f"{e!r}\n{traceback.format_exc()}"))
                    elif kind == "gen":
                        with self._lock:
                            self._sessions = max(0, self._sessions - 1)
                        self.outq.put(("gen_error", self.host, msg[1],
                                       repr(e)))
                    else:
                        logger.exception("worker %d/%d failed a %s",
                                         self.host, self.rid, kind)
                finally:
                    with self._lock:
                        self._pending = max(0, self._pending - 1)
        finally:
            # retiring: wait out live decode sessions, then stop clean
            if engine is not None:
                deadline = time.monotonic() + RETIRE_GRACE_S
                while time.monotonic() < deadline:
                    with self._lock:
                        if self._sessions <= 0:
                            break
                    time.sleep(0.05)
                engine.stop()

    def _handle(self, kind, msg, pred, engine):
        if kind == "batch":
            _, bid, blob = msg
            inputs, n_valid = pickle.loads(blob)
            with telemetry.span(telemetry.SERVE_BATCH,
                                replica=f"{self.host}/{self.rid}",
                                n=n_valid):
                outputs, device_ms = pred(inputs)
            meta = {"device_ms": device_ms, "version": pred.version,
                    "replica": self.rid, "host": self.host}
            self.outq.put(("done", self.host, bid, pickle.dumps(outputs),
                           meta))
        elif kind == "gen":
            _, sid, blob = msg
            if engine is None:
                self.outq.put(("gen_error", self.host, sid,
                               "spec has no decode engine"))
                return
            req = pickle.loads(blob)
            with self._lock:
                self._sessions += 1
            engine.submit(sid, req["prompt"],
                          max_tokens=req.get("max_tokens"),
                          eos_id=req.get("eos_id"),
                          sampling=req.get("sampling"),
                          trace=req.get("trace"))
        elif kind == "reload":
            pin = msg[1]
            if self.payload.get("ckpt_dir") and _maybe_reload(
                    pred, self.payload["ckpt_dir"], step=pin) \
                    and engine is not None:
                engine.set_params(self._decode_params(pred))
            self.outq.put(("reloaded", self.host, pred.version))


class _Host:
    """The worker threads' supervisor inside one fabric host process."""

    def __init__(self, h, payload, device, outq):
        self.h = h
        self.payload = payload
        self.device = device
        self.outq = outq
        self.gen = 0                 # the last scale generation applied
        self._workers = []
        self._next_rid = 0
        self._lock = threading.Lock()

    def _active(self):
        return [w for w in self._workers
                if w.accepting and w.error is None]

    def scale_to(self, n, wait_first=False, timeout=300.0):
        """Grow or shrink to ``n`` accepting workers.  Growth does not
        wait (a new worker admits once its predictor resolves: its inbox
        queues until then); a shrink retires the highest ids first."""
        n = max(1, int(n))
        with self._lock:
            active = self._active()
            while len(active) < n:
                w = _Worker(self.h, self._next_rid, self.payload,
                            self.device, self.outq)
                self._next_rid += 1
                self._workers.append(w)
                w.start()
                active.append(w)
                if wait_first and len(active) == 1:
                    w.ready.wait(timeout)
                    if w.error is not None:
                        raise w.error
            excess = max(0, len(active) - n)
            for w in sorted(active, key=lambda x: -x.rid)[:excess]:
                w.retire()

    def route(self, msg):
        kind = msg[0]
        with self._lock:
            cands = self._active()
        if not cands:
            err = "batch_error" if kind == "batch" else "gen_error"
            self.outq.put((err, self.h, msg[1], "host has no live workers"))
            return
        if kind == "gen":
            _, sid, rid, blob = msg
            w = next((x for x in cands if x.rid == rid), None)
            if w is None:
                w = min(cands, key=lambda x: (x.load(), x.rid))
            w.push(("gen", sid, blob))
        else:
            _, bid, blob = msg
            w = min(cands, key=lambda x: (x.load(), x.rid))
            w.push(("batch", bid, blob))

    def broadcast(self, msg):
        with self._lock:
            for w in self._active():
                w.push(msg)

    def reap(self):
        """Drop retired or broken workers whose threads have ended."""
        with self._lock:
            self._workers = [w for w in self._workers
                             if w.thread.is_alive()
                             or (w.accepting and w.error is None)]

    def n_workers(self):
        with self._lock:
            return len(self._active())

    def version(self):
        with self._lock:
            versions = [w.version() for w in self._active()]
        return max((v for v in versions if v is not None), default=0)

    def load(self):
        with self._lock:
            return sum(w.load() for w in self._active())

    def stats(self):
        import torch

        from tensorflowonspark_tpu_torch import ops

        with self._lock:
            workers = list(self._workers)
        st = {
            "pid": os.getpid(),
            "device": str(self.device),
            "n_workers": self.n_workers(),
            "workers": {w.rid: w.stats() for w in workers
                        if w.error is None},
            # the process's counts: every worker's launches together
            "launches": ops.launch_counts(),
        }
        if self.device.type == "cuda":
            st["peak_mem_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
            st["mem_bytes"] = torch.cuda.memory_allocated(self.device)
        return st

    def endpoint_record(self):
        return {"pid": os.getpid(), "workers": self.n_workers(),
                "load": self.load(), "version": self.version(),
                "ts": time.time()}

    def stop(self):
        with self._lock:
            workers = list(self._workers)
        for w in workers:
            w.retire()
        for w in workers:
            w.thread.join(timeout=5)


class _HostTask:
    """The engine task every fabric host runs (a module-level class,
    shipped with plain ``pickle``): take the device, start the boot
    complement of workers, announce ``up``, then serve the inbox."""

    def __init__(self, payload_blob, mgr_addr, mgr_authkey):
        self.payload_blob = payload_blob
        self.mgr_addr = tuple(mgr_addr)
        self.mgr_authkey = mgr_authkey

    def __call__(self, it):
        items = list(it)
        h = int(os.environ.get("TFOS_PARTITION_INDEX",
                               items[0] if items else 0))
        os.environ[telemetry.NODE_ENV] = f"fabric-host-{h}"
        os.environ[telemetry.ROLE_ENV] = "serving"
        mgr = tfmanager.connect(self.mgr_addr, self.mgr_authkey)
        inq = mgr.queue(_in_queue(h))
        outq = mgr.queue(OUT_QUEUE)
        try:
            import torch

            from tensorflowonspark_tpu_torch import ops, resolve_device

            payload = pickle.loads(self.payload_blob)
            # no CUDA device and no explicit CPU ask: fail here
            device = resolve_device(payload.get("device"))
            if device.type == "cuda":
                torch.cuda.set_device(device)
                torch.cuda.reset_peak_memory_stats(device)
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.\
                    allow_bf16_reduced_precision_reduction = False
            ops.reset_launch_counts()
            fabric_cfg = payload.get("fabric") or {}
            host = _Host(h, payload, device, outq)
            host.scale_to(int(fabric_cfg.get("replicas_per_host", 1)),
                          wait_first=True)
        except BaseException as e:  # noqa: BLE001 - report, then fail task
            outq.put(("init_error", h, f"{e!r}\n{traceback.format_exc()}"))
            raise
        stop_beat = liveness.start_heartbeat(mgr, HEARTBEAT_PREFIX + str(h))
        outq.put(("up", h, os.getpid(), host.version(), host.n_workers()))
        try:
            self._serve(h, host, mgr, inq, outq)
        finally:
            stop_beat.set()
            host.stop()
            outq.put(("down", h))
            telemetry.flush()

    @staticmethod
    def _serve(h, host, mgr, inq, outq):
        last_ep = 0.0
        while True:
            now = time.monotonic()
            if now - last_ep >= 1.0:
                last_ep = now
                try:
                    mgr.set(ENDPOINT_KEY + str(h), host.endpoint_record())
                except Exception:  # noqa: BLE001 - the manager is going
                    pass
            try:
                msg = inq.get(timeout=0.25)
            except _queue.Empty:
                host.reap()
                continue
            kind = msg[0]
            if kind == "stop":
                return
            if kind == "scale":
                _, gen, n = msg
                if gen <= host.gen:
                    continue  # a stale generation: fenced
                host.gen = gen
                try:
                    host.scale_to(int(n))
                except Exception:  # noqa: BLE001 - keep serving
                    logger.exception("scale to %s failed", n)
                outq.put(("scaled", h, gen, host.n_workers()))
            elif kind == "reload":
                # ("reload",) is latest-wins; ("reload", step) pins a step
                host.broadcast(("reload", msg[1] if len(msg) > 1 else None))
            elif kind == "stats":
                outq.put(("stats", h, host.stats()))
            elif kind in ("batch", "gen"):
                host.route(msg)
