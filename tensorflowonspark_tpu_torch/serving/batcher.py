"""Dynamic micro-batcher: coalesce concurrent requests into padded,
power-of-two shape-bucket batches.

An own copy of ``tensorflowonspark_tpu/serving/batcher.py``, whole: the
env defaults, the bucket and pad helpers (which the decode engine uses
too), ``Overloaded``, ``PendingResult``, ``Batch``, ``_signature`` and
``MicroBatcher``.

Why buckets: a predict meets one shape per distinct batch size.
Rounding the batch up to the next power of two (capped at
``TFOS_SERVE_MAX_BATCH``) and padding the rows bounds the shapes a
replica ever sees at ``log2(max_batch)+1`` per input signature.

Latency contract: the first queued request waits at most
``TFOS_SERVE_MAX_DELAY_MS`` for co-batchable traffic before the batch is
flushed (deadline flush); a full batch flushes immediately.

Admission control: once the number of queued-but-unbatched requests
reaches ``TFOS_SERVE_QUEUE_MAX``, ``submit`` sheds load by raising
:class:`Overloaded` (the HTTP frontend maps it to 503 + Retry-After)
instead of growing the queue without bound.

Pure stdlib + numpy: importable by engine executors and the driver alike
(never pulls torch — the replica side owns the model).
"""

from __future__ import annotations

import itertools
import logging
import os
import queue as _queue
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch.actors.ledger import OnceGate, ResolveOnce
from tensorflowonspark_tpu_torch.utils import metrics_registry

logger = logging.getLogger(__name__)

MAX_BATCH_ENV = "TFOS_SERVE_MAX_BATCH"
MAX_DELAY_ENV = "TFOS_SERVE_MAX_DELAY_MS"
QUEUE_MAX_ENV = "TFOS_SERVE_QUEUE_MAX"
TIMEOUT_ENV = "TFOS_SERVE_TIMEOUT"


def max_batch_default():
    return int(os.environ.get(MAX_BATCH_ENV, "64"))


def max_delay_ms_default():
    return float(os.environ.get(MAX_DELAY_ENV, "10"))


def queue_max_default():
    return int(os.environ.get(QUEUE_MAX_ENV, "1024"))


def request_timeout_default():
    return float(os.environ.get(TIMEOUT_ENV, "30"))


def bucket_size(n, cap=None):
    """Smallest power of two >= n, capped at ``cap`` (default
    TFOS_SERVE_MAX_BATCH).  The cap itself is always a legal bucket even
    when it is not a power of two — a full batch pads nothing."""
    cap = max_batch_default() if cap is None else int(cap)
    if n >= cap:
        return cap
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


def bucket_seq(n, cap):
    """Smallest power of two >= n, capped at ``cap`` (the cap itself is
    always a legal bucket).  Same rounding as :func:`bucket_size` but on
    a sequence axis: variable-length prompts compile one executable per
    bucket instead of one per distinct length (or all at max_seq)."""
    cap = int(cap)
    if n >= cap:
        return cap
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


def pad_rows(arr, target):
    """Pad ``arr`` along axis 0 up to ``target`` rows by edge-replication
    (real rows repeated, so padded compute stays numerically in-domain —
    no NaN-able zeros into normalization layers)."""
    arr = np.asarray(arr)
    n = arr.shape[0] if arr.ndim else 0
    if arr.ndim == 0:
        raise ValueError("pad_rows needs at least one (batch) axis")
    if n == target:
        return arr
    if n > target:
        raise ValueError(f"cannot pad {n} rows down to {target}")
    if n == 0:
        raise ValueError("cannot pad an empty batch (no row to replicate)")
    widths = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, mode="edge")


def pad_seq(arr, target, axis=0):
    """Pad ``arr`` along a SEQUENCE axis up to ``target`` by
    edge-replication (the last real step repeated, so padded positions
    stay in-domain — token ids remain valid vocabulary entries).

    Attention-mask safety is split with the model: edge values keep the
    compute finite/in-domain, and the consumer masks padded positions
    using the true lengths the batcher ships alongside
    (``MicroBatcher(seq_axis=...)`` adds a ``_seq_len`` column;
    ``transformer.prefill(lengths=...)`` reads its final REAL position
    and never attends past it causally)."""
    arr = np.asarray(arr)
    if arr.ndim <= axis:
        raise ValueError(f"array rank {arr.ndim} has no axis {axis}")
    n = arr.shape[axis]
    if n == target:
        return arr
    if n > target:
        raise ValueError(f"cannot pad seq {n} down to {target}")
    if n == 0:
        raise ValueError("cannot pad an empty sequence")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(arr, widths, mode="edge")


def pad_columns(cols, target):
    """Pad every column of a batch (dict, tuple or list of arrays) up to
    ``target`` rows; returns the same container type.  Shared by the
    online batcher and the offline pipeline partial-batch path
    (pipeline._run_model)."""
    if isinstance(cols, dict):
        return {k: pad_rows(v, target) for k, v in cols.items()}
    return type(cols)(pad_rows(c, target) for c in cols)


class Overloaded(RuntimeError):
    """Admission control rejection: the pending-request queue is full.

    ``retry_after`` (seconds) is advisory backoff for the client; the
    HTTP frontend surfaces it as a ``Retry-After`` header on the 503.
    """

    def __init__(self, depth, limit, retry_after=0.1):
        super().__init__(
            f"serving queue full ({depth} pending > {limit}); retry in "
            f"{retry_after:.2f}s")
        self.depth = depth
        self.limit = limit
        self.retry_after = retry_after


class PendingResult(ResolveOnce):
    """One request's future: resolved by the batch that absorbed it.
    Resolve-once semantics come from ``actors.ledger.ResolveOnce`` —
    the first complete()/fail() of any batch attempt wins."""

    __slots__ = ("example", "attrs", "t_submit")

    def __init__(self, example):
        super().__init__()
        self.example = example
        self.attrs = None            # timing attrs, set on resolve
        self.t_submit = time.perf_counter()

    def result(self, timeout=None):
        """Block for the outputs row ({tensor_name: ndarray}); raises the
        batch's error, or TimeoutError after ``timeout`` seconds."""
        timeout = request_timeout_default() if timeout is None else timeout
        return self.wait(timeout, "request not served")

    def _set(self, value, attrs):
        self.attrs = attrs
        self.resolve(value)

    def _fail(self, exc):
        self.reject(exc)


class Batch:
    """A padded device batch plus the requests it will resolve.

    ``complete``/``fail`` are idempotent (first call wins): a batch
    re-dispatched after a replica death may be answered twice, and the
    duplicate must be a no-op rather than a double-resolve.
    """

    def __init__(self, batch_id, requests, inputs, bucket, assembly_ms,
                 observer=None, batch_observer=None):
        self.id = batch_id
        self.requests = requests
        self.inputs = inputs          # {tensor_name: [bucket, ...] ndarray}
        self.n_valid = len(requests)
        self.bucket = bucket
        self.assembly_ms = assembly_ms
        self.t_assembled = time.perf_counter()
        self._observer = observer
        self._batch_observer = batch_observer
        self._gate = OnceGate()

    def _claim(self):
        return self._gate.claim()

    def complete(self, outputs, meta=None):
        """Resolve every request with its row of ``outputs`` (padded rows
        beyond ``n_valid`` are discarded)."""
        if not self._claim():
            return False
        meta = meta or {}
        now = time.perf_counter()
        device_ms = float(meta.get("device_ms") or 0.0)
        for i, req in enumerate(self.requests):
            row = {k: v[i] for k, v in outputs.items()}
            attrs = {
                "queue_ms": max(
                    0.0, (self.t_assembled - req.t_submit) * 1e3
                    - self.assembly_ms),
                "batch_ms": self.assembly_ms,
                "device_ms": device_ms,
                "total_ms": (now - req.t_submit) * 1e3,
                "batch": self.n_valid,
                "bucket": self.bucket,
            }
            # replica-reported provenance: which params version answered
            # (canary rollouts split SLO telemetry by this, docs/deployment.md)
            if "version" in meta:
                attrs["version"] = meta["version"]
            if "replica" in meta:
                attrs["replica"] = meta["replica"]
            if self._observer is not None:
                try:
                    self._observer(attrs)
                except Exception:  # noqa: BLE001 - stats must not drop replies
                    logger.exception("serving request observer failed")
            req._set(row, attrs)
        if self._batch_observer is not None:
            try:
                self._batch_observer(self, meta)
            except Exception:  # noqa: BLE001
                logger.exception("serving batch observer failed")
        return True

    def fail(self, exc):
        if not self._claim():
            return False
        for req in self.requests:
            req._fail(exc)
        return True


def _signature(example, seq_axis=None, seq_cap=None):
    """Shape/dtype signature grouping co-batchable examples.

    With ``seq_axis`` set, that per-example axis's length is replaced by
    its power-of-two bucket (:func:`bucket_seq`), so examples of
    different sequence lengths that round to the same bucket co-batch —
    ``_flush`` pads each member up to the bucket (:func:`pad_seq`).
    """
    sig = []
    for k, v in sorted(example.items()):
        shape = tuple(np.shape(v))
        if seq_axis is not None and len(shape) > seq_axis:
            shape = (shape[:seq_axis]
                     + (bucket_seq(shape[seq_axis], seq_cap),)
                     + shape[seq_axis + 1:])
        sig.append((k, shape, str(np.asarray(v).dtype)))
    return tuple(sig)


_STOP = object()


class MicroBatcher:
    """Coalesce ``submit``-ed examples into bucket-padded batches and hand
    them to ``dispatch`` (a non-blocking callable, e.g.
    ``ReplicaPool.dispatch``) from a single batcher thread."""

    def __init__(self, dispatch, max_batch=None, max_delay_ms=None,
                 queue_max=None, observer=None, batch_observer=None,
                 on_shed=None, seq_axis=None, seq_cap=None):
        self._dispatch = dispatch
        self.max_batch = max_batch or max_batch_default()
        self.max_delay_s = (max_delay_ms_default() if max_delay_ms is None
                            else float(max_delay_ms)) / 1e3
        self.queue_max = queue_max or queue_max_default()
        # sequence bucketing (docs/serving.md): group by power-of-two
        # bucket of per-example axis ``seq_axis`` (axis seq_axis+1 of the
        # batched tensor), pad members up by edge-replication, and ship
        # the true lengths as a ``_seq_len`` int32 column so the model
        # can mask the padding (attention-mask-safe by contract).
        self.seq_axis = seq_axis
        self.seq_cap = seq_cap
        if seq_axis is not None and seq_cap is None:
            raise ValueError("seq_axis requires seq_cap (the max length)")
        self._observer = observer
        self._batch_observer = batch_observer
        self._on_shed = on_shed
        self._capacity = 1.0
        self._q = _queue.Queue()
        self._ids = itertools.count(1)
        self._closed = False
        self._thread = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="tfos-serve-batcher", daemon=True)
            self._thread.start()
        return self

    def set_capacity(self, frac):
        """Declared degraded-mode admission (docs/serving.md "Degrade by
        resize"): scale the effective queue bound by the pool's
        live/logical capacity fraction, so load past a shrunk pool sheds
        proportionally with Retry-After instead of queueing into
        timeouts.  ``frac=0`` (no live replicas) sheds everything —
        explicit 503s, never a silent stall."""
        frac = max(0.0, min(1.0, float(frac)))
        if frac != self._capacity:
            logger.info("batcher capacity -> %.0f%% (queue bound %d -> %d)",
                        frac * 100, self.effective_queue_max(),
                        self._bound_for(frac))
        self._capacity = frac

    @property
    def degraded(self):
        return self._capacity < 1.0

    def _bound_for(self, frac):
        return int(round(self.queue_max * frac)) if frac > 0 else 0

    def effective_queue_max(self):
        """Admission bound at the current capacity fraction (>=1 while
        any capacity remains — a degraded pool still serves)."""
        return max(1, self._bound_for(self._capacity)) \
            if self._capacity > 0 else 0

    def submit(self, example):
        """Queue one example ({tensor_name: array-like}, no batch axis);
        returns a :class:`PendingResult`.  Raises :class:`Overloaded`
        past ``queue_max`` pending requests (load shed)."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        if not isinstance(example, dict) or not example:
            raise TypeError(
                "example must be a non-empty {tensor_name: array} dict")
        depth = self._q.qsize()
        metrics_registry.set_gauge("tfos_serve_queue_depth", depth)
        limit = self.effective_queue_max()
        if depth >= limit:
            # shed BEFORE enqueueing: bounded queue depth is the whole
            # point — admitting then failing would still grow memory
            if self._on_shed is not None:
                try:
                    self._on_shed(depth, limit)
                except Exception:  # noqa: BLE001
                    logger.exception("serving shed observer failed")
            # degraded sheds hint a longer backoff: capacity returns on
            # pool-regrow timescales, not batch-flush timescales
            retry = max(self.max_delay_s, 0.05)
            if self.degraded:
                retry = max(retry, 0.25)
            raise Overloaded(depth, limit, retry_after=retry)
        req = PendingResult(
            {k: np.asarray(v) for k, v in example.items()})
        self._q.put(req)
        return req

    def _loop(self):
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except _queue.Empty:
                if self._closed:
                    return
                continue
            if first is _STOP:
                return
            reqs = [first]
            deadline = time.perf_counter() + self.max_delay_s
            stop = False
            while len(reqs) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    r = self._q.get(timeout=remaining)
                except _queue.Empty:
                    break
                if r is _STOP:
                    stop = True
                    break
                reqs.append(r)
            self._flush(reqs)
            if stop:
                return

    def _flush(self, reqs):
        """Stack one gathered wave into per-signature bucket batches."""
        groups = {}
        for req in reqs:
            groups.setdefault(
                _signature(req.example, self.seq_axis, self.seq_cap),
                []).append(req)
        for sig, members in groups.items():
            t0 = time.perf_counter()
            try:
                if self.seq_axis is None:
                    cols = {
                        k: np.stack([m.example[k] for m in members])
                        for k in members[0].example
                    }
                else:
                    buckets = {k: s for k, s, _ in sig}
                    cols = {}
                    for k in members[0].example:
                        tgt = buckets[k]
                        cols[k] = np.stack([
                            (pad_seq(m.example[k],
                                     tgt[self.seq_axis], axis=self.seq_axis)
                             if len(tgt) > self.seq_axis
                             else m.example[k])
                            for m in members])
                    lk = sorted(members[0].example)[0]
                    cols["_seq_len"] = np.asarray(
                        [np.shape(m.example[lk])[self.seq_axis]
                         if len(np.shape(m.example[lk])) > self.seq_axis
                         else 0 for m in members], np.int32)
                bucket = bucket_size(len(members), self.max_batch)
                cols = pad_columns(cols, bucket)
            except Exception as e:  # noqa: BLE001 - bad example payloads
                for m in members:
                    m._fail(e)
                continue
            batch = Batch(
                next(self._ids), members, cols, bucket,
                (time.perf_counter() - t0) * 1e3,
                observer=self._observer,
                batch_observer=self._batch_observer,
            )
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 - pool refused the batch
                batch.fail(e)

    def close(self, timeout=5.0):
        """Stop the batcher thread; queued-but-unflushed requests are
        failed so no client blocks into its full timeout on shutdown."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_STOP)
        if self._thread is not None:
            self._thread.join(timeout)
        err = RuntimeError("server shut down before the request was batched")
        while True:
            try:
                req = self._q.get_nowait()
            except _queue.Empty:
                break
            if req is not _STOP:
                req._fail(err)
