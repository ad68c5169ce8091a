"""Replica pool: N model replicas as supervised engine executors.

Counterpart of ``tensorflowonspark_tpu/serving/replicas.py``, on the
port's own runtime:

- replicas run as ``engine.foreach_partition(spread=True,
  retryable=True)`` tasks, so a SIGKILLed replica is respawned by the
  engine's supervision (``engine._respawn_executor``) and its task blob
  re-dispatched byte for byte;
- requests and answers travel through the port's IPC manager
  (``manager.TFManager`` named queues), started in the driver: one
  inbox per replica and one shared out-queue.  A manager proxy opens a
  connection (an auth handshake) for each thread that uses it, so every
  message to a replica leaves from one pool thread (``_send``), not
  from the caller's (an HTTP handler thread a request), and each
  replica keeps its proxies for its life;
- liveness is the keyed manager-KV heartbeat (``actors.liveness``) plus
  direct executor-process checks.

Dispatch is least-loaded among live replicas (ties broken by index),
through ``actors.dispatch.InFlightTable`` (keys ``("batch", id)`` /
``("gen", sid)``).  In-flight work of a dead replica is re-dispatched
to survivors; ``batcher.Batch`` and ``decode.scheduler.PendingSession``
resolve once, so a duplicate answer is a no-op.

Checkpoint hot reload: when the spec names a ``ckpt_dir``, a watcher
thread polls ``utils/checkpoint.latest`` every ``TFOS_SERVE_RELOAD_SECS``
and sends an in-band ``reload`` to every replica, ordered behind the
work already queued: in-flight requests finish on the old params, later
ones see the new.  A decode replica hands the new params to
``DecodeEngine.set_params``.

Differences from the JAX package:

- Plain ``pickle``, no ``cloudpickle``: the replica task is an instance
  of the module-level :class:`_ReplicaTask`; ``ModelSpec.predict`` is a
  module-level function or a ``"module:qualname"`` string.  A JAX
  package's predict name in an export's metadata maps to the port's
  counterpart through :data:`JAX_PREDICTS` (MNIST's and linear
  regression's); any other JAX name raises.
- No ``jax.jit``: predicts run eagerly, with the same compile-count
  contract (one entry per new input signature).  ``jit=True`` raises;
  a CUDA graph per bucket is ROADMAP.md queue 1, item 26.
- ``ModelSpec.device`` (default: the card) goes to the decode engine
  and to the predict as ``predict(params, inputs, device=...)``.  A
  replica without a CUDA device that was not asked for the CPU fails at
  init, and :meth:`ReplicaPool.start` raises: it never serves on the CPU
  instead.
- Each replica zeroes the kernels' launch counts at boot and reports
  them, with its peak device memory, in its ``stats`` reply.
- Canary routing, the version watermark and the elastic pool are not
  ported (ROADMAP.md queue 1, item 25): their methods raise.
"""

from __future__ import annotations

import importlib
import logging
import os
import pickle
import queue as _queue
import threading
import time
import traceback

import numpy as np

from tensorflowonspark_tpu_torch import manager as tfmanager
from tensorflowonspark_tpu_torch.actors import liveness
from tensorflowonspark_tpu_torch.actors.dispatch import InFlightTable
from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)

REPLICAS_ENV = "TFOS_SERVE_REPLICAS"
RELOAD_SECS_ENV = "TFOS_SERVE_RELOAD_SECS"
RETRIES_ENV = "TFOS_SERVE_RETRIES"

HEARTBEAT_PREFIX = "serve_heartbeat:"
OUT_QUEUE = "serve_out"

CANARY_ITEM = ("ROADMAP.md queue 1, item 25 (canary routing, the version "
               "watermark, the deploy loop, the elastic pool and the fabric)")
CUDA_GRAPH_ITEM = "ROADMAP.md queue 1, item 26 (a CUDA graph per bucket)"

# the JAX package's predict names an export may carry, and the port's
# counterparts that serve the same params
JAX_PREDICTS = {
    "tensorflowonspark_tpu.models.mnist:predict":
        "tensorflowonspark_tpu_torch.models.mnist:predict",
    "tensorflowonspark_tpu.models.mnist:serve_predict":
        "tensorflowonspark_tpu_torch.models.mnist:predict",
    "tensorflowonspark_tpu.models.linear:predict":
        "tensorflowonspark_tpu_torch.models.linear:predict",
}


def num_replicas_default():
    return int(os.environ.get(REPLICAS_ENV, "2"))


def reload_secs_default():
    return float(os.environ.get(RELOAD_SECS_ENV, "2"))


def max_retries_default():
    return int(os.environ.get(RETRIES_ENV, "8"))


def _in_queue(idx):
    return f"serve_in_{idx}"


class ModelSpec:
    """What a replica serves.  Two resolution paths:

    - ``export_dir``: a ``utils/checkpoint.export_model`` directory; the
      predict is the export metadata's ``predict`` ("module:qualname")
      entry, overridable with ``predict`` here.
    - ``predict`` as a module-level function or "module:qualname" string
      (plus ``params``), shipped to replicas with plain ``pickle``.

    ``ckpt_dir`` arms hot reload: replicas start from the newest
    checkpoint in it (else the export's params) and the pool's watcher
    broadcasts reloads as new steps appear.

    ``decode``: a ``serving.decode.scheduler.DecodeSpec`` mounts the
    continuous-batching decode engine on every replica; the pool then
    takes ``dispatch_session``.  A decode-only spec needs no predict;
    its params (the JAX layout, as exports and checkpoints hold them)
    resolve from ``export_dir``/``params``/``ckpt_dir``.

    ``device``: where replicas compute, default the card (None); pass
    ``"cpu"`` for the CPU.  ``jit``: None or False run eagerly; True
    raises NotImplementedError (ROADMAP.md queue 1, item 26).
    """

    def __init__(self, export_dir=None, ckpt_dir=None, predict=None,
                 params=None, jit=None, decode=None, device=None):
        if export_dir is None and predict is None and decode is None:
            raise ValueError(
                "ModelSpec needs an export_dir, a predict "
                "function/'module:qualname' string, or a decode spec")
        if jit:
            raise NotImplementedError(
                f"compiled predicts come with {CUDA_GRAPH_ITEM}; "
                "jit=None or False serve eagerly")
        self.export_dir = export_dir
        self.ckpt_dir = ckpt_dir
        self.predict = predict
        self.params = params
        self.jit = jit
        self.decode = decode
        self.device = device

    def to_payload(self):
        return {
            "export_dir": self.export_dir,
            "ckpt_dir": self.ckpt_dir,
            "predict": self.predict,
            "params": self.params,
            "jit": self.jit,
            "decode": self.decode,
            "device": self.device,
        }


class _Predictor:
    """Replica-side model: params plus the compile-count contract.

    One entry is added to ``compiles`` exactly when a new (shape, dtype)
    signature is first seen, as the JAX package's eager path does; the
    batcher's buckets keep signatures at ``log2(max_batch)+1`` per input
    layout.  ``device_ms`` is measured once the outputs are numpy arrays,
    which waits for the device."""

    def __init__(self, fn, params, version, device):
        self._fn = fn
        self.params = params
        self.version = version
        self.device = device
        self._seen = set()
        self.compiles = {}           # sig str -> count
        self.batches = 0
        self.rows = 0
        self.device_ms = 0.0

    @staticmethod
    def _sig(inputs):
        return tuple((k, tuple(v.shape), str(v.dtype))
                     for k, v in sorted(inputs.items()))

    def __call__(self, inputs):
        if self._fn is None:
            raise RuntimeError(
                "this spec serves decode sessions only (no predict "
                "signature); use generate, not predict")
        sig = self._sig(inputs)
        if sig not in self._seen:
            self._seen.add(sig)
            key = str(sig)
            self.compiles[key] = self.compiles.get(key, 0) + 1
        t0 = time.perf_counter()
        out = self._fn(self.params, inputs, device=self.device)
        out = {k: np.asarray(v) for k, v in out.items()}
        dur = (time.perf_counter() - t0) * 1e3
        self.batches += 1
        self.rows += next(iter(inputs.values())).shape[0]
        self.device_ms += dur
        return out, dur

    def stats(self):
        return {
            "version": self.version,
            "compiles": dict(self.compiles),
            "batches": self.batches,
            "rows": self.rows,
            "device_ms": round(self.device_ms, 3),
        }


def _import_qualname(spec):
    """Resolve a "module:qualname" predict spec.  The JAX package's
    names map through :data:`JAX_PREDICTS`; any other JAX name raises
    ValueError, since the port imports nothing of that package."""
    if spec.split(":", 1)[0].split(".", 1)[0] == "tensorflowonspark_tpu":
        if spec not in JAX_PREDICTS:
            raise ValueError(
                f"predict {spec!r} names a function of the JAX package, "
                "which the port does not import and has no counterpart "
                "for; pass predict= (a module-level function or a "
                "'module:qualname' string of the port)")
        spec = JAX_PREDICTS[spec]
    mod_name, _, fn_name = spec.partition(":")
    fn = importlib.import_module(mod_name)
    for part in fn_name.split("."):
        fn = getattr(fn, part)
    return fn


def _resolve_predictor(payload, device):
    """Build the replica's :class:`_Predictor` from a ModelSpec payload."""
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    fn = payload.get("predict")
    params = payload.get("params")
    if payload.get("export_dir"):
        params, meta = ckpt.load_exported(payload["export_dir"])
        if not callable(fn):
            spec = (fn if isinstance(fn, str) else None) or meta.get("predict")
            if not spec and payload.get("decode") is None:
                raise ValueError(
                    f"export {payload['export_dir']} has no 'predict' "
                    "metadata and the spec names no function")
            fn = _import_qualname(spec) if spec else None
    elif isinstance(fn, str):
        fn = _import_qualname(fn)
    pred = _Predictor(fn, params, 0, device)
    if payload.get("ckpt_dir"):
        _maybe_reload(pred, payload["ckpt_dir"])
    if pred.params is None:
        raise ValueError("no params: provide export_dir, params, or a "
                         "ckpt_dir containing a checkpoint")
    return pred


def _maybe_reload(pred, ckpt_dir, step=None):
    """Swap in new params; True when they changed.  ``step=None``: the
    newest restorable checkpoint, if newer than ``pred.version`` (the
    latest-wins watcher); ``step=N``: that step exactly."""
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    if step is not None:
        step = int(step)
        if step == pred.version:
            return False
        pred.params = ckpt.restore_step(ckpt_dir, step)
        pred.version = step
        logger.info("replica pinned params at step %d", step)
        return True
    step, _path = ckpt.latest(ckpt_dir)
    if step is None or step == pred.version:
        return False
    tree, step = ckpt.restore_any(ckpt_dir)
    if tree is None or step == pred.version:
        return False
    pred.params = tree
    pred.version = step
    logger.info("replica reloaded params at step %d", step)
    return True


def _decode_params(tree, cfg):
    """An export's or checkpoint's transformer tree (the JAX layout) as
    host tensors; the decode engine places and casts them on its own
    device and thread."""
    from tensorflowonspark_tpu_torch.models import transformer

    return transformer.params_from_jax(tree, cfg, device="cpu")


class _ReplicaTask:
    """The engine task every replica runs (a module-level class, so the
    engine ships it with plain ``pickle``): connect to the pool's
    manager, build the predictor and the decode engine, announce
    ``up``, then serve the inbox until ``stop``."""

    def __init__(self, payload_blob, mgr_addr, mgr_authkey):
        self.payload_blob = payload_blob
        self.mgr_addr = tuple(mgr_addr)
        self.mgr_authkey = mgr_authkey

    def __call__(self, it):
        items = list(it)
        idx = int(os.environ.get("TFOS_PARTITION_INDEX",
                                 items[0] if items else 0))
        os.environ[telemetry.NODE_ENV] = f"replica-{idx}"
        os.environ[telemetry.ROLE_ENV] = "serving"
        mgr = tfmanager.connect(self.mgr_addr, self.mgr_authkey)
        inq = mgr.queue(_in_queue(idx))
        outq = mgr.queue(OUT_QUEUE)
        engine = None
        try:
            import torch

            from tensorflowonspark_tpu_torch import ops, resolve_device

            payload = pickle.loads(self.payload_blob)
            # no CUDA device and no explicit CPU ask: fail here, never
            # serve on the CPU instead
            device = resolve_device(payload.get("device"))
            if device.type == "cuda":
                torch.cuda.set_device(device)
                torch.cuda.reset_peak_memory_stats(device)
                # float32 stays float32 and bf16 products accumulate in
                # float32, as in the port's trainers
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.\
                    allow_bf16_reduced_precision_reduction = False
            ops.reset_launch_counts()
            pred = _resolve_predictor(payload, device)
            spec = payload.get("decode")
            if spec is not None:
                from tensorflowonspark_tpu_torch.serving.decode.scheduler \
                    import DecodeEngine

                def _gen_emit(kind, sid, *rest):
                    outq.put(("gen_" + kind, idx, sid) + tuple(rest))

                engine = DecodeEngine(
                    _decode_params(pred.params, spec.cfg), spec, _gen_emit,
                    replica=idx, device=device).start()
        except BaseException as e:  # noqa: BLE001 - report, then fail task
            outq.put(("init_error", idx, f"{e!r}\n{traceback.format_exc()}"))
            raise
        stop_beat = liveness.start_heartbeat(mgr, HEARTBEAT_PREFIX + str(idx))
        outq.put(("up", idx, os.getpid(), pred.version))
        try:
            self._serve(idx, payload, pred, engine, device, inq, outq)
        finally:
            stop_beat.set()
            if engine is not None:
                engine.stop()
            outq.put(("down", idx))
            telemetry.flush()

    @staticmethod
    def _serve(idx, payload, pred, engine, device, inq, outq):
        import torch

        from tensorflowonspark_tpu_torch import ops

        while True:
            try:
                msg = inq.get(timeout=1.0)
            except _queue.Empty:
                continue
            kind = msg[0]
            if kind == "stop":
                return
            if kind == "reload":
                # ("reload",) is latest-wins; ("reload", step) pins a step
                pin = msg[1] if len(msg) > 1 else None
                try:
                    if payload.get("ckpt_dir") and _maybe_reload(
                            pred, payload["ckpt_dir"], step=pin) \
                            and engine is not None:
                        engine.set_params(_decode_params(
                            pred.params, payload["decode"].cfg))
                    outq.put(("reloaded", idx, pred.version))
                except Exception as e:  # noqa: BLE001 - keep serving
                    logger.exception("reload failed")
                    outq.put(("reload_error", idx, repr(e)))
            elif kind == "stats":
                st = pred.stats()
                st["pid"] = os.getpid()
                st["device"] = str(device)
                st["launches"] = ops.launch_counts()
                if device.type == "cuda":
                    st["peak_mem_bytes"] = torch.cuda.max_memory_allocated(
                        device)
                if engine is not None:
                    st["decode"] = engine.stats()
                outq.put(("stats", idx, st))
            elif kind == "gen":
                _, sid, blob = msg
                if engine is None:
                    outq.put(("gen_error", idx, sid,
                              "spec has no decode engine"))
                    continue
                try:
                    req = pickle.loads(blob)
                    engine.submit(sid, req["prompt"],
                                  max_tokens=req.get("max_tokens"),
                                  eos_id=req.get("eos_id"),
                                  sampling=req.get("sampling"),
                                  trace=req.get("trace"))
                except Exception as e:  # noqa: BLE001 - one bad
                    # session must not take the replica down
                    outq.put(("gen_error", idx, sid, repr(e)))
            elif kind == "batch":
                _, batch_id, blob = msg
                try:
                    inputs, n_valid = pickle.loads(blob)
                    with telemetry.span(telemetry.SERVE_BATCH,
                                        replica=idx, n=n_valid):
                        outputs, device_ms = pred(inputs)
                    meta = {"device_ms": device_ms,
                            "version": pred.version, "replica": idx}
                    outq.put(("done", idx, batch_id,
                              pickle.dumps(outputs), meta))
                except Exception as e:  # noqa: BLE001 - one bad
                    # batch must not take the replica down
                    outq.put(("batch_error", idx, batch_id,
                              f"{e!r}\n{traceback.format_exc()}"))


class ReplicaPool:
    """Owns the replicas' engine job, the IPC manager, dispatch, failover
    and hot reload.  ``dispatch(batch)`` is the MicroBatcher's sink."""

    def __init__(self, spec, num_replicas=None, engine=None, env=None,
                 max_retries=None, request_timeout=None):
        self.spec = spec
        self.num_replicas = int(num_replicas or num_replicas_default())
        self._engine = engine
        self._owns_engine = engine is None
        self._env = dict(env) if env else None
        self._max_retries = (max_retries_default() if max_retries is None
                             else int(max_retries))
        self._request_timeout = request_timeout
        self._mgr = None
        self._inqs = {}
        self._outq = None
        self._sendq = _queue.Queue()  # (idx, message) for the sender
        self._lock = threading.Lock()
        self._table = InFlightTable(self.num_replicas)
        self._versions = {}          # idx -> last acked params version
        self._stats_replies = {}
        self._stats_event = threading.Event()
        self._registered = threading.Event()
        self._init_errors = {}       # idx -> message, during start()
        self._job_error = None
        self._stop = threading.Event()
        self._threads = []
        self.respawns_observed = 0
        self.replayed_tokens = 0     # duplicate token arrivals, dropped
        self.boot_s = None           # start() to every replica up
        self.up_times = {}           # idx -> [monotonic time of each up]

    # -- lifecycle -----------------------------------------------------------
    def start(self, timeout=180.0):
        """Launch the replicas and wait until all are up.  Raises when a
        replica reports an init error (no CUDA device, a bad export), when
        the job fails, or after ``timeout``; the pool is stopped first.
        A started pool is returned as it is (``with Server(...).start()``
        starts it once): a second launch would leave the first engine's
        executors and manager running, unstopped."""
        if self._mgr is not None:
            return self
        t0 = time.monotonic()
        try:
            self._start(timeout)
        except BaseException:
            self.stop()
            raise
        self.boot_s = time.monotonic() - t0
        return self

    def _start(self, timeout):
        if self._owns_engine:
            from tensorflowonspark_tpu_torch.engine import LocalEngine

            self._engine = LocalEngine(self.num_replicas, env=self._env)
        if self.num_replicas > self._engine.num_executors:
            raise ValueError(
                f"{self.num_replicas} replicas need as many executors; the "
                f"engine has {self._engine.num_executors}")
        authkey = os.urandom(16)
        self._mgr = tfmanager.start(
            authkey,
            [OUT_QUEUE] + [_in_queue(i) for i in range(self.num_replicas)])
        self._inqs = {i: self._mgr.get_queue(_in_queue(i))
                      for i in range(self.num_replicas)}
        self._outq = self._mgr.get_queue(OUT_QUEUE)
        task = _ReplicaTask(pickle.dumps(self._payload()),
                            tuple(self._mgr.address), authkey)

        def _launch():
            try:
                ds = self._engine.parallelize(
                    list(range(self.num_replicas)), self.num_replicas)
                ds.foreach_partition(task, spread=True, retryable=True,
                                     max_retries=self._max_retries)
            except BaseException as e:  # noqa: BLE001 - surfaced by start
                self._job_error = e
                if not self._stop.is_set():
                    logger.error("serving replica job failed: %s", e)

        for name, target in (("tfos-serve-launch", _launch),
                             ("tfos-serve-send", self._sender),
                             ("tfos-serve-collect", self._collect),
                             ("tfos-serve-monitor", self._monitor)):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        if self.spec.ckpt_dir:
            t = threading.Thread(target=self._watch_reload,
                                 name="tfos-serve-reload", daemon=True)
            t.start()
            self._threads.append(t)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._init_errors:
                idx, err = sorted(self._init_errors.items())[0]
                raise RuntimeError(
                    f"replica {idx} failed to start: {err}")
            if self._job_error is not None:
                raise RuntimeError(
                    f"replica pool failed to start: {self._job_error}")
            if len(self._table.live()) >= self.num_replicas:
                self._init_errors = None   # later init errors only log
                return
            self._registered.wait(0.2)
            self._registered.clear()
        raise TimeoutError(
            f"replicas not up within {timeout}s "
            f"({len(self._table.live())}/{self.num_replicas})")

    def stop(self):
        """Fail what is in flight, stop the replicas, join their job,
        then stop the engine if the pool owns it and the manager."""
        if self._stop.is_set():
            return
        self._stop.set()
        err = RuntimeError("replica pool stopped")
        for key, entry in self._table.drain():
            if key[0] == "batch":
                entry["batch"].fail(err)
            else:
                entry["session"]._fail(err)
        for idx in self._inqs:
            self._send(idx, ("stop",))
        self._sendq.put(None)  # the sender exits once the stops are out
        for t in self._threads:
            if t.name == "tfos-serve-send":
                t.join(timeout=10)
        launch = [t for t in self._threads if t.name == "tfos-serve-launch"]
        for t in launch:  # live replicas return on "stop"
            t.join(timeout=10 if self._table.live() else 0.5)
        if self._owns_engine and self._engine is not None:
            self._engine.stop()  # ends a job still retrying a replica
            for t in launch:
                t.join(timeout=5)
        if self._mgr is not None:
            try:
                self._mgr.shutdown()
            except Exception:  # noqa: BLE001
                pass

    def _payload(self):
        return self.spec.to_payload()

    def _send(self, idx, msg):
        """Queue ``msg`` for replica ``idx``'s inbox (in order)."""
        self._sendq.put((idx, msg))

    def _sender(self):
        """The one thread that puts into the replicas' inboxes, over one
        manager connection for the pool's life."""
        while True:
            item = self._sendq.get()
            if item is None:
                return
            idx, msg = item
            try:
                self._inqs[idx].put(msg)
            except Exception:  # noqa: BLE001 - manager shut down
                logger.warning("could not send %s to replica %d", msg[0],
                               idx)

    # -- dispatch ------------------------------------------------------------
    def dispatch(self, batch):
        """Send one batcher Batch to the least-loaded live replica.
        Called from the batcher thread; never blocks on the device."""
        faults.check("serve.dispatch", what="batch", id=batch.id)
        if self._job_error is not None and not self._table.live():
            raise RuntimeError(
                f"no replicas left (job failed: {self._job_error})")
        blob = pickle.dumps((batch.inputs, batch.n_valid))
        idx = self._table.add(("batch", batch.id),
                              {"batch": batch, "blob": blob})
        self._send(idx, ("batch", batch.id, blob))

    def dispatch_session(self, session):
        """Send one decode :class:`~.decode.scheduler.PendingSession` to
        the least-loaded live replica.  A dead replica's sessions are
        re-dispatched to survivors (a full re-prefill there), and the
        session's index-keyed ledger makes the replay zero-drop and
        zero-duplicate."""
        faults.check("serve.dispatch", what="gen", id=session.id)
        if self.spec.decode is None:
            raise RuntimeError("spec has no decode engine; pass "
                               "ModelSpec(..., decode=DecodeSpec(...))")
        if self._job_error is not None and not self._table.live():
            raise RuntimeError(
                f"no replicas left (job failed: {self._job_error})")
        blob = pickle.dumps({
            "prompt": session.prompt,
            "max_tokens": session.max_tokens,
            "eos_id": session.eos_id,
            # the resolved sampling dict (seed included) rides the blob,
            # so a failover re-dispatch replays the identical stream
            "sampling": session.sampling,
            # traceparent: the replica's decode spans join the request's
            # trace tree
            "trace": session.trace,
        })
        idx = self._table.add(("gen", session.id),
                              {"session": session, "blob": blob})
        self._send(idx, ("gen", session.id, blob))

    def cancel_session(self, sid):
        """Forget a session (the client gave up): its slot keeps
        generating replica-side, but late answers find no entry."""
        return self._table.pop(("gen", sid)) is not None

    def outstanding_sessions(self):
        return sum(1 for k in self._table.keys() if k[0] == "gen")

    # -- canary / staged rollout: not ported ----------------------------------
    def _no_canary(self, *args, **kwargs):
        raise NotImplementedError(f"staged rollout comes with {CANARY_ITEM}")

    set_watermark = set_canary = promote_canary = rollback_canary = \
        pin_version = canary_stats = canary_snapshot = _no_canary

    # -- background threads ---------------------------------------------------
    def _collect(self):
        """Drain the out-queue: registrations, answers, acks."""
        while not self._stop.is_set():
            try:
                msg = self._outq.get(timeout=0.25)
            except _queue.Empty:
                continue
            except Exception:  # noqa: BLE001 - manager shut down
                return
            try:
                self._handle(msg)
            except Exception:  # noqa: BLE001 - one bad message
                logger.exception("serve_out message %r failed", msg[:3])

    def _handle(self, msg):
        kind = msg[0]
        if kind == "up":
            _, idx, pid, version = msg
            respawned = self._table.up(idx, pid)
            with self._lock:
                self._versions[idx] = version
                self.up_times.setdefault(idx, []).append(time.monotonic())
            if respawned:
                self.respawns_observed += 1
            self._registered.set()
            telemetry.event("serve/replica_up", replica=idx, pid=pid,
                            version=version)
            if respawned:
                # the respawned incarnation's "up" can beat the monitor's
                # death scan: re-dispatch what the old one owned (work
                # still queued in its inherited inbox is at worst
                # answered twice, and resolves once)
                self._record_lost(idx, "respawned")
                self._redispatch({idx})
        elif kind == "down":
            self._table.down(msg[1])
        elif kind == "done":
            _, idx, batch_id, payload, meta = msg
            entry = self._table.pop(("batch", batch_id))
            if entry is None:
                return  # duplicate answer after a re-dispatch
            try:
                entry["batch"].complete(pickle.loads(payload), meta)
            except Exception as e:  # noqa: BLE001
                entry["batch"].fail(e)
        elif kind == "batch_error":
            _, idx, batch_id, tb = msg
            entry = self._table.pop(("batch", batch_id))
            if entry is not None:
                entry["batch"].fail(RuntimeError(
                    f"replica {idx} failed the batch:\n{tb}"))
        elif kind == "gen_token":
            _, idx, sid, tindex, tok = msg
            # a streamed token proves the stream is alive
            entry = self._table.touch(("gen", sid))
            if entry is not None and not entry["session"]._token(tindex,
                                                                 tok):
                self.replayed_tokens += 1  # a failover replay's duplicate
        elif kind == "gen_done":
            _, idx, sid, tokens, meta = msg
            entry = self._table.pop(("gen", sid))
            if entry is not None:
                entry["session"]._set(tokens, meta)
        elif kind == "gen_error":
            _, idx, sid, err = msg
            entry = self._table.pop(("gen", sid))
            if entry is not None:
                entry["session"]._fail(RuntimeError(
                    f"replica {idx} failed the decode session: {err}"))
        elif kind == "reloaded":
            with self._lock:
                self._versions[msg[1]] = msg[2]
            telemetry.event("serve/replica_reloaded", replica=msg[1],
                            version=msg[2])
        elif kind == "stats":
            self._stats_replies[msg[1]] = msg[2]
            self._stats_event.set()
        elif kind in ("init_error", "reload_error"):
            logger.warning("replica %s reported %s: %s", msg[1], kind,
                           msg[2])
            errors = self._init_errors
            if kind == "init_error" and errors is not None:
                errors[msg[1]] = msg[2]
                self._registered.set()

    def _monitor(self):
        """Failure detection: executor-process death (fast path) and
        stale heartbeats (wedged replica).  Either way the replica's
        in-flight work is re-dispatched to survivors."""
        while not self._stop.wait(0.2):
            now = time.monotonic()
            dead = liveness.scan(self._table.live(), self._proc_alive,
                                 self._beat_age, liveness.stale_after())
            for idx, why in dead:
                self._table.lost(idx)
                logger.warning("replica %d lost (%s); re-dispatching its "
                               "in-flight work", idx, why)
                self._record_lost(idx, why)
            if dead:
                self._redispatch({idx for idx, _ in dead})
            # a decode session's clock restarts at every streamed token,
            # so only a stalled stream times out, not a long generation
            for key, entry in self._table.stale(self._request_timeout, now):
                if key[0] == "batch":
                    entry["batch"].fail(TimeoutError(
                        "batch not answered within "
                        f"{self._request_timeout}s"))
                else:
                    entry["session"]._fail(TimeoutError(
                        "decode session streamed no token within "
                        f"{self._request_timeout}s"))

    def _redispatch(self, dead_idxs):
        """Re-send a dead replica's in-flight work to survivors.  Decode
        sessions re-prefill on their new replica and re-stream identical
        ``(index, token)`` pairs; the session ledger keeps the first
        arrivals.  With no survivor the entries stay assigned: the
        respawned replica drains the inbox it inherited."""
        moved = {"batch": 0, "gen": 0}
        for key in self._table.owned_by(dead_idxs):
            idx = self._table.reassign(key)
            entry = self._table.get(key)
            if idx is None or entry is None:
                continue
            self._send(idx, (key[0], key[1], entry["blob"]))
            moved[key[0]] += 1
        if moved["batch"] or moved["gen"]:
            telemetry.event("serve/redispatch", batches=moved["batch"],
                            sessions=moved["gen"], to=self._table.live())

    def _record_lost(self, idx, why):
        """One replica death: the event, and a flight dump with the
        dispatch table's keys (never a prompt or a blob)."""
        telemetry.event("serve/replica_lost", replica=idx, reason=why)
        try:  # a dump never blocks the failover
            from tensorflowonspark_tpu_torch.obs import flight

            flight.snapshot("serve/replica_lost", node=f"replica-{idx}",
                            reason=why, inflight=self._inflight_summary())
        except Exception:  # noqa: BLE001 - dumps are best-effort
            logger.debug("flight snapshot failed", exc_info=True)

    def _inflight_summary(self, limit=32):
        """The dispatch table in small scalars: kind, id and the
        session's trace header."""
        out = []
        for key in list(self._table.keys())[:limit]:
            entry = self._table.get(key)
            if entry is None:
                continue
            item = {"kind": key[0], "id": key[1]}
            sess = entry.get("session") if isinstance(entry, dict) else None
            if sess is not None and getattr(sess, "trace", None):
                item["trace"] = sess.trace
            out.append(item)
        return out

    def _proc_alive(self, idx):
        procs = getattr(self._engine, "_procs", None)
        if not procs:
            return True  # foreign engine: no process visibility
        try:
            return procs[idx % len(procs)].is_alive()
        except Exception:  # noqa: BLE001
            return True

    def _beat_age(self, idx):
        return liveness.beat_age(self._mgr, HEARTBEAT_PREFIX + str(idx))

    def _watch_reload(self):
        """Poll ``utils/checkpoint.latest``; broadcast in-band reloads."""
        from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

        with self._lock:
            last = max(self._versions.values(), default=0)
        interval = reload_secs_default()
        while not self._stop.wait(interval):
            try:
                step, _path = ckpt.latest(self.spec.ckpt_dir)
            except Exception:  # noqa: BLE001 - transient fs error
                continue
            if step is None or step == last:
                continue
            last = step
            metrics_registry.inc("tfos_serve_reloads_total")
            telemetry.event(telemetry.SERVE_RELOAD, step=step)
            logger.info("hot-reload: broadcasting checkpoint step %d", step)
            for idx in self._table.live():
                self._send(idx, ("reload",))

    # -- introspection --------------------------------------------------------
    def live_replicas(self):
        return self._table.live()

    def replica_pids(self):
        return self._table.pids()

    def versions(self):
        with self._lock:
            return dict(self._versions)

    def stats(self, timeout=10.0):
        """Broadcast a stats request; gather each replica's stats
        (version, compile counts per signature, batches, rows, kernel
        launches, peak device memory, the decode engine's counters)."""
        targets = self._table.live()
        self._stats_replies = {}
        self._stats_event.clear()
        for idx in targets:
            self._send(idx, ("stats",))
        deadline = time.monotonic() + timeout
        while (set(self._stats_replies) < set(targets)
               and time.monotonic() < deadline):
            self._stats_event.wait(0.1)
            self._stats_event.clear()
        return dict(self._stats_replies)
