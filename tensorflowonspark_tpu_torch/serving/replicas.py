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

Canary routing: ``set_canary`` pins a subset of replicas at a candidate
version (an in-band ``("reload", step)``: a pinned reload may go down a
version, unlike the latest-wins watcher) and splits dispatch by request
id (:func:`canary_arm`, crc32 mod 100, the JAX package's split): about
``pct``% of traffic lands on the canary arm, the rest on the baseline,
least-loaded within the arm.  Each arm's outcomes accumulate in the
``tfos_deploy_*`` metrics and in ``canary_stats`` for the promotion
controller's burn-window verdict; ``promote_canary`` reloads the
baseline at the candidate and advances the watermark,
``rollback_canary`` re-pins the canary arm at the blessed watermark.
While a watermark is set the latest-wins watcher stands down, and a
respawned replica that booted at another version is steered back to its
arm's pin (``_enforce_version``).

Differences from the JAX package:

- Plain ``pickle``, no ``cloudpickle``: the replica task is an instance
  of the module-level :class:`_ReplicaTask`; ``ModelSpec.predict`` is a
  module-level function or a ``"module:qualname"`` string.  A JAX
  package's predict name in an export's metadata maps to the port's
  counterpart through :data:`JAX_PREDICTS` (MNIST's and linear
  regression's); any other JAX name raises.
- A CUDA graph per signature takes the place of ``jax.jit``: on the
  card a replica captures the predict's device part
  (``predict.parts``, ``utils/cuda_graphs.py``) at a signature's first
  sight and replays it after, with the same compile-count contract (one
  ``compiles`` entry per signature).  ``jit=None`` serves a signature it
  cannot capture eagerly, says why once in the log and counts it in
  ``stats()["eager_signatures"]``; ``jit=True`` raises there instead,
  and on the CPU, where no graph exists; ``jit=False`` never captures.
  The decode engine takes the same ``jit`` for its steps.
- ``ModelSpec.device`` (default: the card) goes to the decode engine
  and to the predict as ``predict(params, inputs, device=...)``.  A
  replica without a CUDA device that was not asked for the CPU fails at
  init, and :meth:`ReplicaPool.start` raises: it never serves on the CPU
  instead.
- Each replica zeroes the kernels' launch counts at boot and reports
  them (the launches that ran on the device, each graph replay adding
  the launches its capture recorded), with its peak device memory, in
  its ``stats`` reply.
- The elastic boot gate's mirror and every other message carry host
  numpy trees, never a CUDA tensor (``serving.elastic.params_blob``).
"""

from __future__ import annotations

import bisect
import importlib
import logging
import os
import pickle
import queue as _queue
import threading
import time
import traceback
import zlib

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
    ``"cpu"`` for the CPU.  ``jit``: on the card, None captures a CUDA
    graph per signature where it can and serves eagerly where it cannot
    (logged once, counted in ``eager_signatures``); True raises where a
    capture fails; False serves eagerly.  The decode engine's steps
    follow the same rule.  On the CPU no graph exists: None and False
    serve eagerly, and True raises ValueError.
    """

    def __init__(self, export_dir=None, ckpt_dir=None, predict=None,
                 params=None, jit=None, decode=None, device=None):
        if export_dir is None and predict is None and decode is None:
            raise ValueError(
                "ModelSpec needs an export_dir, a predict "
                "function/'module:qualname' string, or a decode spec")
        if jit is True and _is_cpu(device):
            raise ValueError("jit=True needs CUDA graphs, which the CPU "
                             "does not have; pass jit=None or False")
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


def _is_cpu(device):
    """Whether ``device`` (a ``torch.device``, a string or None) names
    the CPU; None is the card."""
    return str(getattr(device, "type", device) or "").startswith("cpu")


class _Predictor:
    """Replica-side model: params plus per-signature CUDA graphs.

    The compile-count contract: one entry is added to ``compiles``
    exactly when a new (mesh shape, shape, dtype) signature is first
    seen, as in the JAX package; the batcher's buckets keep signatures at
    ``log2(max_batch)+1`` per input layout.  On the card (``jit`` None or
    True) that first sight captures the predict's device part
    (``fn.parts``, a :class:`~..utils.cuda_graphs.PredictParts`) into a
    graph, which every later call of the signature replays; the host
    conversions stay outside it.  ``jit=None`` serves a signature it
    cannot capture (no CUDA device, no ``parts``, a failed capture)
    eagerly, logs the first reason and counts it in ``eager_signatures``;
    ``jit=True`` raises instead; ``jit=False`` never captures.  New
    params (a reload, an adoption) are copied into the captured ones in
    place where their shapes and dtypes match; otherwise the graphs are
    dropped and recaptured, each recapture one more ``compiles``.
    ``graphs``: the :class:`~..utils.cuda_graphs.GraphCache` to use (the
    CPU tests inject one with a plain-call capture).  ``device_ms`` is
    measured once the outputs are numpy arrays, which waits for the
    device."""

    def __init__(self, fn, params, version, device, jit=None, graphs=None):
        from tensorflowonspark_tpu_torch.utils import cuda_graphs

        self._fn = fn
        self._parts = getattr(fn, "parts", None)
        self.version = version
        self.device = device
        self.jit = jit
        if graphs is None and jit is not False and \
                cuda_graphs.is_cuda(device):
            graphs = cuda_graphs.GraphCache(device)
        if jit is True and fn is not None and (
                graphs is None or self._parts is None):
            raise ValueError(
                "jit=True needs a CUDA device and a predict with a device "
                f"part (predict.parts); device {device}, predict {fn!r}")
        self._graphs = graphs
        self._dev_params = None      # what the graphs read, on the device
        self.params = params
        self._seen = set()
        self._eager = set()          # signatures served eagerly
        self._eager_logged = False
        self.compiles = {}           # sig str -> count
        self.mesh_shape = None       # set by an elastic resize
        self.batches = 0
        self.rows = 0
        self.device_ms = 0.0

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, tree):
        # a reload or an adoption: the graphs' params follow at the next
        # call (refilled in place, or recaptured)
        self._params = tree
        self._params_new = True

    def _sig(self, inputs):
        # keyed by (mesh shape, shapes/dtypes), as in the JAX package:
        # after an elastic resize the same bucket counts a new signature
        return (self.mesh_shape,) + tuple(
            (k, tuple(v.shape), str(v.dtype))
            for k, v in sorted(inputs.items()))

    def _device_params(self):
        """The params the graphs read: converted once a version, refilled
        in place where the new ones match, else replaced (the graphs
        dropped, so each signature recaptures and counts again)."""
        from tensorflowonspark_tpu_torch.utils import cuda_graphs

        if self._params_new:
            new = cuda_graphs.own(
                self._parts.params(self._params, self.device), self._params)
            if self._dev_params is None or not cuda_graphs.refill(
                    self._dev_params, new):
                if len(self._graphs):
                    self._graphs.clear()
                    self._seen.clear()
                self._dev_params = new
            self._params_new = False
        return self._dev_params

    def _note_eager(self, sig, why):
        if sig not in self._eager:
            self._eager.add(sig)
            if self.jit is not False and not self._eager_logged:
                self._eager_logged = True
                logger.info("predict not captured in a CUDA graph (%s); "
                            "serving eagerly", why)

    def _capture(self, sig, inputs):
        """Capture ``sig``'s graph; None where ``jit=None`` lets a failed
        capture serve eagerly."""
        import torch

        parts = self._parts
        dev_params = self._device_params()
        try:
            with torch.no_grad():
                return self._graphs.capture(
                    sig, lambda *a: parts.core(dev_params, *a),
                    parts.inputs(inputs))
        except Exception as e:  # noqa: BLE001 - jit=None serves on
            if self.jit is True:
                raise
            self._note_eager(sig, repr(e))
            return None

    def _run(self, sig, inputs):
        graph = None
        if self._graphs is None or self._parts is None:
            self._note_eager(sig, "no CUDA device" if self._graphs is None
                             else "the predict has no device part "
                                  "(predict.parts)")
        elif sig not in self._eager:
            graph = self._graphs.get(sig) or self._capture(sig, inputs)
        if graph is None:
            return self._fn(self.params, inputs, device=self.device)
        return self._parts.outputs(graph(*self._parts.inputs(inputs)))

    def __call__(self, inputs):
        if self._fn is None:
            raise RuntimeError(
                "this spec serves decode sessions only (no predict "
                "signature); use generate, not predict")
        if self._graphs is not None and self._parts is not None:
            self._device_params()   # a reload may drop the graphs
        sig = self._sig(inputs)
        if sig not in self._seen:
            self._seen.add(sig)
            key = str(sig)
            self.compiles[key] = self.compiles.get(key, 0) + 1
        t0 = time.perf_counter()
        out = self._run(sig, inputs)
        out = {k: np.asarray(v) for k, v in out.items()}
        dur = (time.perf_counter() - t0) * 1e3
        self.batches += 1
        self.rows += next(iter(inputs.values())).shape[0]
        self.device_ms += dur
        return out, dur

    def stats(self):
        graphs = self._graphs
        return {
            "version": self.version,
            "compiles": dict(self.compiles),
            "batches": self.batches,
            "rows": self.rows,
            "device_ms": round(self.device_ms, 3),
            "graphs": len(graphs) if graphs is not None else 0,
            "capture_ms": (round(graphs.capture_ms, 3)
                           if graphs is not None else 0.0),
            "eager_signatures": len(self._eager),
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
    pred = _Predictor(fn, params, 0, device, jit=payload.get("jit"))
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


def _incarnation_alive(engine, table, idx):
    """The liveness scan's process check of member ``idx`` of
    ``table`` (an ``InFlightTable``), placed on ``engine``'s executor
    ``idx``: False when that executor's process is dead, or alive under
    another pid than the member's registered ``up`` (a respawn that won
    the race with the scan).  True without process visibility."""
    procs = getattr(engine, "_procs", None)
    if not procs:
        return True  # foreign engine: no process visibility
    try:
        proc = procs[idx % len(procs)]
        registered = table.pids().get(idx)
        if registered is not None and proc.pid != registered:
            return False
        return proc.is_alive()
    except Exception:  # noqa: BLE001
        return True


def canary_arm(route_id, pct):
    """True when ``route_id`` hashes into the canary arm: crc32 of its
    string form, mod 100, below ``pct``.  The same id lands on the same
    arm in every process (an int and its string agree), as in the JAX
    package."""
    return (zlib.crc32(str(route_id).encode()) % 100) < float(pct)


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
        elastic = None
        el_state = {"gen": 0, "covered": None, "resizes": 0, "boot": "cold"}
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
            if payload.get("elastic"):
                # the elastic boot gate (serving/elastic.py): announce
                # this incarnation, then boot as the pool says: "cold"
                # from the spec, or "adopt" the survivors' live params
                from tensorflowonspark_tpu_torch.serving import (
                    elastic,
                )

                t_hello = time.perf_counter()
                outq.put(("hello", idx, os.getpid()))
                boot = elastic.await_boot(inq)
                # hello to the directive in hand (the mirror unpickled)
                el_state["directive_s"] = time.perf_counter() - t_hello
                if boot[0] == "stop":
                    outq.put(("down", idx))
                    return
                if boot[0] == "adopt":
                    pred = elastic.adopt_predictor(payload, boot[1],
                                                   boot[2], device)
                    el_state["boot"] = "adopted"
                else:
                    pred = _resolve_predictor(payload, device)
            else:
                pred = _resolve_predictor(payload, device)
            spec = payload.get("decode")
            if spec is not None:
                from tensorflowonspark_tpu_torch.serving.decode.scheduler \
                    import DecodeEngine

                def _gen_emit(kind, sid, *rest):
                    if kind == "done":  # the version that retired it
                        rest = (rest[0], dict(rest[1], version=pred.version))
                    outq.put(("gen_" + kind, idx, sid) + tuple(rest))

                engine = DecodeEngine(
                    _decode_params(pred.params, spec.cfg), spec, _gen_emit,
                    replica=idx, device=device,
                    jit=payload.get("jit")).start()
            if elastic is not None:
                # the directive in hand to serving: the predictor and the
                # decode engine's params on the device
                el_state["ready_s"] = (time.perf_counter() - t_hello
                                       - el_state["directive_s"])
        except BaseException as e:  # noqa: BLE001 - report, then fail task
            outq.put(("init_error", idx, f"{e!r}\n{traceback.format_exc()}"))
            raise
        stop_beat = liveness.start_heartbeat(mgr, HEARTBEAT_PREFIX + str(idx))
        outq.put(("up", idx, os.getpid(), pred.version))
        if elastic is not None and el_state["boot"] == "cold":
            # seed the pool's mirror, so the next incarnation can adopt
            outq.put(("params_sync", idx, pred.version,
                      elastic.params_blob(pred.params)))
        try:
            self._serve(idx, payload, pred, engine, device, inq, outq,
                        elastic, el_state)
        finally:
            stop_beat.set()
            if engine is not None:
                engine.stop()
            outq.put(("down", idx))
            telemetry.flush()

    @staticmethod
    def _serve(idx, payload, pred, engine, device, inq, outq, elastic,
               el_state):
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
                            pred, payload["ckpt_dir"], step=pin):
                        if engine is not None:
                            engine.set_params(_decode_params(
                                pred.params, payload["decode"].cfg))
                        if elastic is not None:
                            outq.put(("params_sync", idx, pred.version,
                                      elastic.params_blob(pred.params)))
                    outq.put(("reloaded", idx, pred.version))
                except Exception as e:  # noqa: BLE001 - keep serving
                    logger.exception("reload failed")
                    outq.put(("reload_error", idx, repr(e)))
            elif kind == "resize":
                _, gen, covered, logical = msg
                if gen <= el_state["gen"]:
                    continue  # a stale generation: fenced
                try:
                    # one card a replica: the placement is the identity,
                    # so the decode engine keeps its params
                    ms = elastic.apply_resize(pred, covered, logical)
                    el_state.update(gen=gen, covered=covered,
                                    resizes=el_state["resizes"] + 1)
                    outq.put(("resized", idx, gen, covered, ms))
                except Exception as e:  # noqa: BLE001 - keep serving on
                    # the previous layout; the pool retries
                    logger.exception("resize to covered=%s failed", covered)
                    outq.put(("resize_error", idx, gen, repr(e)))
            elif kind == "stats":
                st = pred.stats()
                st["pid"] = os.getpid()
                st["device"] = str(device)
                st["launches"] = ops.launch_counts()
                if device.type == "cuda":
                    st["peak_mem_bytes"] = torch.cuda.max_memory_allocated(
                        device)
                    # the graphs' pools included: what this replica holds
                    st["mem_bytes"] = torch.cuda.memory_allocated(device)
                if engine is not None:
                    st["decode"] = engine.stats()
                if elastic is not None:
                    st["elastic"] = dict(el_state)
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
        # staged rollout (under self._lock): the open canary split, the
        # blessed watermark, and bounded per-arm outcomes
        self._canary = None          # {"replicas", "version", "pct"}
        self._watermark = None       # the blessed step the pool is pinned to
        self._reload_watermark = None  # newest latest-wins broadcast step
        self._arm_stats = None       # arm -> {"n", "errors", "ms": [...]}
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
        idx = self._route(("batch", batch.id),
                          {"batch": batch, "blob": blob}, batch.id)
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
        idx = self._route(("gen", session.id),
                          {"session": session, "blob": blob}, session.id)
        self._send(idx, ("gen", session.id, blob))

    def cancel_session(self, sid):
        """Forget a session (the client gave up): its slot keeps
        generating replica-side, but late answers find no entry."""
        return self._table.pop(("gen", sid)) is not None

    def outstanding_sessions(self):
        return sum(1 for k in self._table.keys() if k[0] == "gen")

    def _route(self, key, entry, route_id):
        """The owner: least-loaded overall, or, with a canary open,
        least-loaded within the arm ``route_id`` hashes into.  An arm with
        no live member falls back to any live replica: a split never
        drops a request."""
        with self._lock:
            canary = self._canary
        if canary is None:
            return self._table.add(key, entry)
        # the arm's latency runs from here: the entry's "t" restarts at
        # every streamed token (the liveness clock)
        entry["t_submit"] = time.monotonic()
        arm = "canary" if canary_arm(route_id, canary["pct"]) else "baseline"
        live = self._table.live()
        if arm == "canary":
            cands = [i for i in live if i in canary["replicas"]]
        else:
            cands = [i for i in live if i not in canary["replicas"]]
        entry["arm"] = arm
        if not cands:
            return self._table.add(key, entry)
        loads = self._table.loads()
        owner = min(cands, key=lambda i: (loads.get(i, 0), i))
        return self._table.add(key, entry, owner=owner)

    def _account(self, entry, ok):
        """Count a resolved entry that was dispatched under a canary
        split into its arm (the ``tfos_deploy_*`` metrics and the bounded
        samples :meth:`canary_stats` reads); others are not counted.  Its
        milliseconds run from the dispatch (a decode session's whole
        latency: its TTFT and token gaps included)."""
        arm = entry.get("arm")
        if arm is None:
            return
        # the dispatch time _route stamped; an entry made elsewhere has
        # only the table's clock
        ms = (time.monotonic() - entry.get("t_submit", entry["t"])) * 1e3
        metrics_registry.inc("tfos_deploy_requests_total", arm=arm,
                             status="ok" if ok else "error")
        metrics_registry.observe("tfos_deploy_request_ms", ms, arm=arm)
        with self._lock:
            st = (self._arm_stats or {}).get(arm)
            if st is None:
                return
            st["n"] += 1
            if not ok:
                st["errors"] += 1
            st["ms"].append(ms)
            del st["ms"][:-512]  # bounded: enough for a burn window's p95

    # -- canary / staged rollout ----------------------------------------------
    def set_watermark(self, step):
        """Pin the blessed version.  While set, the latest-wins watcher
        stands down (the promotion controller owns version changes) and a
        replica that comes up at another version is steered to its arm's
        pin.  ``None`` releases the pin."""
        with self._lock:
            self._watermark = None if step is None else int(step)

    def watermark(self):
        with self._lock:
            return self._watermark

    def reload_watermark(self):
        """The newest step the latest-wins watcher has broadcast (None
        before the first): without a promotion watermark, a respawn
        converges on it, the version the survivors serve."""
        with self._lock:
            return self._reload_watermark

    def set_canary(self, replicas, version, pct):
        """Open a canary: pin ``replicas`` at candidate ``version`` (an
        in-band pinned reload) and route about ``pct``% of traffic to
        them.  The arm must leave at least one baseline replica."""
        arm = tuple(sorted(int(i) for i in replicas))
        live = self._table.live()
        if not arm or not set(arm) <= set(live):
            raise ValueError(f"canary replicas {arm} not all live ({live})")
        if len(arm) >= len(live):
            raise ValueError("canary arm must leave a baseline replica")
        version = int(version)
        with self._lock:
            self._canary = {"replicas": arm, "version": version,
                            "pct": float(pct)}
            self._arm_stats = {
                "canary": {"n": 0, "errors": 0, "ms": []},
                "baseline": {"n": 0, "errors": 0, "ms": []},
            }
        for idx in arm:
            self._send(idx, ("reload", version))
        metrics_registry.set_gauge("tfos_deploy_canary_step", version)
        telemetry.event(telemetry.DEPLOY_CANARY, version=version,
                        replicas=list(arm), pct=float(pct))
        logger.info("canary open: replicas %s at step %d (%s%% traffic)",
                    arm, version, pct)
        return arm

    def promote_canary(self):
        """The candidate wins: reload the baseline at it, advance the
        watermark, clear the split.  Returns the promoted step."""
        with self._lock:
            canary = self._canary
        if canary is None:
            raise RuntimeError("promote_canary: no canary open")
        version = canary["version"]
        for idx in self._table.live():
            if idx not in canary["replicas"]:
                self._send(idx, ("reload", version))
        with self._lock:
            self._watermark = version
            self._canary = None
        logger.info("canary promoted: pool pinned at step %d", version)
        return version

    def rollback_canary(self, step=None):
        """The candidate loses: re-pin the canary arm at the watermark
        (or ``step``), clear the split.  Returns the step rolled back to."""
        with self._lock:
            canary = self._canary
            target = self._watermark if step is None else int(step)
        if canary is None:
            raise RuntimeError("rollback_canary: no canary open")
        if target is None:
            raise RuntimeError("rollback_canary: no watermark to re-pin")
        for idx in canary["replicas"]:
            self._send(idx, ("reload", target))
        with self._lock:
            self._watermark = target
            self._canary = None
        logger.info("canary rolled back: arm %s re-pinned at step %d",
                    canary["replicas"], target)
        return target

    def pin_version(self, step):
        """Pin the whole pool at blessed ``step``: a pinned reload on
        every live replica and the watermark (the deploy loop's bootstrap
        and its recovery after a driver restart)."""
        step = int(step)
        for idx in self._table.live():
            self._send(idx, ("reload", step))
        self.set_watermark(step)
        return step

    def canary(self):
        """The open split (``{"replicas", "version", "pct"}``) or None."""
        with self._lock:
            return dict(self._canary) if self._canary else None

    def canary_stats(self):
        """Each arm's outcomes since the split opened:
        ``{arm: {"n", "errors", "p50_ms", "p95_ms"}}``."""
        with self._lock:
            out = {}
            for arm, st in (self._arm_stats or {}).items():
                ms = sorted(st["ms"])
                out[arm] = {
                    "n": st["n"],
                    "errors": st["errors"],
                    "p50_ms": ms[len(ms) // 2] if ms else None,
                    "p95_ms": ms[int(len(ms) * 0.95)] if ms else None,
                }
            return out

    def canary_snapshot(self):
        """The split's outcomes as a registry snapshot (``{metric:
        {"type", "series"}}``), the input of ``obs.slo.evaluate``, so the
        promotion verdict runs the live metrics plane's SLO math.  The
        samples are bucketed on the default histogram bounds; empty
        without an open split."""
        bounds = list(metrics_registry.DEFAULT_BUCKETS_MS)
        counters, hists = [], []
        with self._lock:
            if self._arm_stats is None:
                return {}
            for arm, st in sorted(self._arm_stats.items()):
                counters.append({"labels": {"arm": arm, "status": "ok"},
                                 "value": float(st["n"] - st["errors"])})
                counters.append({"labels": {"arm": arm, "status": "error"},
                                 "value": float(st["errors"])})
                counts = [0] * (len(bounds) + 1)
                for v in st["ms"]:
                    counts[bisect.bisect_left(bounds, v)] += 1
                hists.append({"labels": {"arm": arm}, "bounds": bounds,
                              "counts": counts, "sum": float(sum(st["ms"])),
                              "count": len(st["ms"])})
        return {"tfos_deploy_requests_total": {"type": "counter",
                                               "series": counters},
                "tfos_deploy_request_ms": {"type": "histogram",
                                           "series": hists}}

    def _enforce_version(self, idx, version):
        """A replica that just came up booted at the newest checkpoint,
        which mid-canary may be the unblessed candidate: steer it to its
        arm's pin with a pinned reload."""
        with self._lock:
            canary, wm = self._canary, self._watermark
        if canary is not None and idx in canary["replicas"]:
            want = canary["version"]
        else:
            want = wm
        if want is not None and version != want:
            self._send(idx, ("reload", want))

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
                if not self._handle_extra(msg):
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
            self._enforce_version(idx, version)
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
                self._account(entry, ok=True)
            except Exception as e:  # noqa: BLE001
                entry["batch"].fail(e)
                self._account(entry, ok=False)
        elif kind == "batch_error":
            _, idx, batch_id, tb = msg
            entry = self._table.pop(("batch", batch_id))
            if entry is not None:
                entry["batch"].fail(RuntimeError(
                    f"replica {idx} failed the batch:\n{tb}"))
                self._account(entry, ok=False)
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
                self._account(entry, ok=True)
        elif kind == "gen_error":
            _, idx, sid, err = msg
            entry = self._table.pop(("gen", sid))
            if entry is not None:
                entry["session"]._fail(RuntimeError(
                    f"replica {idx} failed the decode session: {err}"))
                self._account(entry, ok=False)
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

    def _handle_extra(self, msg):
        """A subclass's hook, called before :meth:`_handle`: consume the
        pool's own out-queue messages (the elastic pool's boot, mirror
        and resize acks).  True when the message was handled."""
        return False

    def _tick(self):
        """A subclass's hook, called once a monitor pass (the elastic
        pool reconciles membership with its assignments)."""

    def _monitor(self):
        """Failure detection: executor-process death (fast path) and
        stale heartbeats (wedged replica).  Either way the replica's
        in-flight work is re-dispatched to survivors."""
        while not self._stop.wait(0.2):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - the next pass retries
                logger.exception("pool tick failed")
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
                self._account(entry, ok=False)

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
        """Whether replica ``idx``'s registered incarnation lives: its
        executor slot's process is alive and is the one whose ``up`` the
        table registered.  The engine respawns a killed executor at once,
        so a live process with another pid means the registered one died
        (its sessions fail over now, not at the respawn's boot)."""
        return _incarnation_alive(self._engine, self._table, idx)

    def _beat_age(self, idx):
        return liveness.beat_age(self._mgr, HEARTBEAT_PREFIX + str(idx))

    def _watch_reload(self):
        """Poll ``utils/checkpoint.latest``; broadcast in-band reloads."""
        from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

        with self._lock:
            last = max(self._versions.values(), default=0)
        interval = reload_secs_default()
        while not self._stop.wait(interval):
            with self._lock:
                managed = (self._watermark is not None
                           or self._canary is not None)
            if managed:
                # a promotion controller owns version changes: latest-wins
                # broadcasts would race the pinned arms
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
