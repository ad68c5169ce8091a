"""Structured telemetry: per-process span/event records on one schema.

An own copy of ``tensorflowonspark_tpu/utils/telemetry.py``, with the
same env gate and record format: enabled iff ``TFOS_TELEMETRY_DIR`` is
set (a cached no-op otherwise), one JSONL file per process, records
buffered in a bounded ring::

    {"ts": <epoch s>, "node_id": ..., "role": ...,
     "kind": "span"|"event", "name": ..., "dur_ms": <float>|null,
     "attrs": {...}}

Under an active W3C-traceparent-shaped context, records carry
``trace_id``/``span_id``/``parent_id`` in ``attrs``; a serving request's
``traceparent`` header rides its dispatch blob to the replica, whose
decode spans join the request's tree.  ``trace_root`` anchors a
long-lived scope (``cluster.run``) and exports its context on
``TFOS_TRACE_PARENT``, where spawned and forked children inherit it.

The drain: a node pins its processes' identity and a node-local spool
directory (``configure``; ``TFOS_TELEMETRY_SPOOL``), advertises the
spool in its manager's KV (``register_with``), and at shutdown the
driver collects every spool (``read_spool``, which drops a line a
killed writer left truncated) into ``run_dir(cluster_id)``.  Every
process also keeps its last ``TFOS_FLIGHT_RING`` records in memory
(``recent``), which ``obs.flight`` freezes to disk when supervision
sees a death.  Stdlib only.

Env vars: ``TFOS_TELEMETRY_DIR`` (the switch and the driver's sink and
run directory), ``TFOS_TELEMETRY_SPOOL`` (a process's sink, node-local),
``TFOS_TELEMETRY_NODE`` / ``TFOS_TELEMETRY_ROLE`` (identity, inherited
by children), ``TFOS_TELEMETRY_BUFFER`` (ring capacity, 4096 records),
``TFOS_TELEMETRY_FLUSH`` (flush threshold, 128), ``TFOS_TRACE_PARENT``
(the causal parent) and ``TFOS_FLIGHT_RING`` (512 records).
"""

from __future__ import annotations

import atexit
import collections
import json
import logging
import multiprocessing.util
import os
import re
import socket
import threading
import time

logger = logging.getLogger(__name__)

DIR_ENV = "TFOS_TELEMETRY_DIR"
SPOOL_ENV = "TFOS_TELEMETRY_SPOOL"
NODE_ENV = "TFOS_TELEMETRY_NODE"
ROLE_ENV = "TFOS_TELEMETRY_ROLE"
BUFFER_ENV = "TFOS_TELEMETRY_BUFFER"
FLUSH_ENV = "TFOS_TELEMETRY_FLUSH"
TRACE_ENV = "TFOS_TRACE_PARENT"
RING_ENV = "TFOS_FLIGHT_RING"

SCHEMA_KEYS = ("ts", "node_id", "role", "kind", "name", "dur_ms", "attrs")

# serving names: one span per served request, one event per shed
SERVE_REQUEST = "serve/request"
SERVE_SHED = "serve/shed"
SERVE_BATCH = "serve/replica_batch"   # replica-side device batch span
SERVE_RELOAD = "serve/reload"         # hot-reload broadcast event
DECODE_SESSION = "decode/session"     # one autoregressive decode session
DECODE_SHED = "decode/shed"           # decode admission-control rejection
SERVE_GENERATE = "serve/generate"     # request-root span, /v1/generate
SERVE_PREDICT = "serve/predict"       # request-root span, /v1/predict
DECODE_ADMIT = "decode/admit"         # replica-side session admission
DECODE_RETIRE = "decode/retire"       # replica-side session retirement
ACTOR_MESSAGE = "actor/message"       # one actor envelope handled
EVAL_RUN = "eval/run"                 # one eval-sidecar evaluation
BENCH_REQUEST = "bench/request"       # loadgen per-request root span
CLUSTER_RUN = "cluster/run"           # cluster root-trace anchor
DATA_UNIT = "data/unit"               # one exactly-once data unit served
DEPLOY_BLESS = "deploy/bless"         # checkpoint passed gate, manifest out
DEPLOY_CANARY = "deploy/canary"       # canary arm opened on a candidate
DEPLOY_PROMOTE = "deploy/promote"     # candidate promoted fleet-wide
DEPLOY_ROLLBACK = "deploy/rollback"   # candidate rejected, blessed re-pinned

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


class TraceContext:
    """One node of a causal request tree (wire form ``to_header()``)."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id=None, span_id=None, parent_id=None):
        self.trace_id = trace_id or os.urandom(16).hex()
        self.span_id = span_id or os.urandom(8).hex()
        self.parent_id = parent_id

    def child(self):
        """A fresh context one level down (new span_id, parented here)."""
        return TraceContext(self.trace_id, None, self.span_id)

    def to_header(self):
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_header(cls, header):
        """Parse a traceparent string; None on anything malformed."""
        if isinstance(header, TraceContext):
            return header
        m = _TRACEPARENT_RE.match(str(header or "").strip())
        if not m:
            return None
        return cls(m.group(1), m.group(2))


_TRACE_TLS = threading.local()
_ENV_PARENT = {"raw": None, "ctx": None}


def current():
    """The active TraceContext of this thread, else the
    ``TFOS_TRACE_PARENT`` env channel, else None."""
    stack = getattr(_TRACE_TLS, "stack", None)
    if stack:
        return stack[-1]
    raw = os.environ.get(TRACE_ENV)
    if not raw:
        return None
    if _ENV_PARENT["raw"] != raw:
        _ENV_PARENT["ctx"] = TraceContext.from_header(raw)
        _ENV_PARENT["raw"] = raw
    return _ENV_PARENT["ctx"]


def _push(ctx):
    stack = getattr(_TRACE_TLS, "stack", None)
    if stack is None:
        stack = _TRACE_TLS.stack = []
    stack.append(ctx)


def _pop(ctx):
    stack = getattr(_TRACE_TLS, "stack", None)
    if stack and stack[-1] is ctx:
        stack.pop()


class _Activation:
    """CM scoping an existing context onto this thread."""

    __slots__ = ("_ctx",)

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        if self._ctx is not None:
            _push(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        if self._ctx is not None:
            _pop(self._ctx)
        return False


def activate(ctx):
    """``with telemetry.activate(ctx_or_header):`` — make a received
    context the active parent for records in the body.  No-op for None
    or when telemetry is disabled."""
    if ctx is None or _get() is None:
        return _Activation(None)
    if not isinstance(ctx, TraceContext):
        ctx = TraceContext.from_header(ctx)
    return _Activation(ctx)


class Recorder:
    """Per-process span/event sink: bounded buffer -> one JSONL file,
    and the flight ring of the last records, which flushing leaves."""

    def __init__(self, sink_dir):
        self.sink_dir = sink_dir
        self.pid = os.getpid()
        self.node_id = (os.environ.get(NODE_ENV)
                        or f"{socket.gethostname()}-{self.pid}")
        self.role = os.environ.get(ROLE_ENV) or "proc"
        self.path = os.path.join(sink_dir,
                                 f"{_safe(self.node_id)}-{self.pid}.jsonl")
        cap = int(os.environ.get(BUFFER_ENV, "4096"))
        self._flush_every = int(os.environ.get(FLUSH_ENV, "128"))
        self._buf = collections.deque(maxlen=max(cap, 1))
        self.ring = collections.deque(
            maxlen=max(int(os.environ.get(RING_ENV, "512")), 1))
        self._lock = threading.Lock()
        self._last_flush = time.monotonic()
        self._sink_warned = False
        self.dropped = 0
        # a multiprocessing child leaves through os._exit and runs only
        # the Finalize registry, a plain interpreter only atexit
        atexit.register(self.flush)
        multiprocessing.util.Finalize(self, Recorder.flush, args=(self,),
                                      exitpriority=100)

    def record(self, kind, name, ts, dur_ms, attrs):
        rec = {"ts": ts, "node_id": self.node_id, "role": self.role,
               "kind": kind, "name": name, "dur_ms": dur_ms,
               "attrs": attrs or {}}
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(rec)
            self.ring.append(rec)
            need = (len(self._buf) >= self._flush_every
                    or time.monotonic() - self._last_flush > 1.0)
        if need:
            self.flush()

    def flush(self):
        if os.getpid() != self.pid:
            return  # a fork child must not re-write the parent's records
        with self._lock:
            if not self._buf:
                return
            recs = list(self._buf)
            self._buf.clear()
            dropped, self.dropped = self.dropped, 0
            self._last_flush = time.monotonic()
        if dropped:
            recs.insert(0, {
                "ts": time.time(), "node_id": self.node_id,
                "role": self.role, "kind": "event",
                "name": "telemetry/dropped", "dur_ms": None,
                "attrs": {"count": dropped}})
        try:
            os.makedirs(self.sink_dir, exist_ok=True)
            data = "".join(json.dumps(r, default=str) + "\n" for r in recs)
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(data)
        except OSError as e:
            if not self._sink_warned:  # degrade quietly, never crash
                self._sink_warned = True
                logger.warning("telemetry sink unwritable (%s): %s",
                               self.path, e)


def _safe(name):
    return "".join(c if (c.isalnum() or c in "-_.") else "_"
                   for c in str(name)) or "node"


_STATE = {"key": None, "rec": None}
_STATE_LOCK = threading.Lock()


def _get():
    key = (os.getpid(), os.environ.get(DIR_ENV),
           os.environ.get(SPOOL_ENV), os.environ.get(NODE_ENV),
           os.environ.get(ROLE_ENV))
    if _STATE["key"] == key:
        return _STATE["rec"]
    with _STATE_LOCK:
        if _STATE["key"] == key:
            return _STATE["rec"]
        old = _STATE["rec"]
        if old is not None and old.pid == os.getpid():
            old.flush()
        base = key[1]
        _STATE["rec"] = Recorder(key[2] or base) if base else None
        _STATE["key"] = key
        return _STATE["rec"]


def enabled():
    """True when telemetry is recording in this process."""
    return _get() is not None


def sink_path():
    """This process's JSONL sink, or None when disabled."""
    rec = _get()
    return rec.path if rec is not None else None


def configure(node_id=None, role=None, spool=None):
    """Pin this process's identity and sink through the env, so that
    forked and spawned children inherit them; returns the recorder (or
    None when disabled)."""
    for env, value in ((NODE_ENV, node_id), (ROLE_ENV, role),
                       (SPOOL_ENV, spool)):
        if value is not None:
            os.environ[env] = str(value)
    return _get()


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **attrs):
        return self


_NULL = _NullSpan()


class Span:
    """Context manager measuring one span on the monotonic clock.  Under
    an active context it derives (or is handed) a child context, makes
    it the active parent for its body and stamps ``trace_id``/
    ``span_id``/``parent_id`` into its attrs on exit."""

    __slots__ = ("_rec", "name", "attrs", "_ts", "_t0", "_ctx")

    def __init__(self, rec, name, attrs, ctx=None):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self._ctx = ctx

    def __enter__(self):
        self._ts = time.time()
        self._t0 = time.perf_counter()
        if self._ctx is None:
            parent = current()
            if parent is not None:
                self._ctx = parent.child()
        if self._ctx is not None:
            _push(self._ctx)
        return self

    def add(self, **attrs):
        self.attrs.update(attrs)
        return self

    @property
    def ctx(self):
        """This span's TraceContext (None outside any trace)."""
        return self._ctx

    def __exit__(self, exc_type, exc, tb):
        dur_ms = (time.perf_counter() - self._t0) * 1000.0
        if self._ctx is not None:
            _pop(self._ctx)
            self.attrs.setdefault("trace_id", self._ctx.trace_id)
            self.attrs.setdefault("span_id", self._ctx.span_id)
            self.attrs.setdefault("parent_id", self._ctx.parent_id)
        if exc_type is not None:
            self.attrs.setdefault("error", repr(exc)[:200])
        self._rec.record("span", self.name, self._ts, dur_ms, self.attrs)
        return False


def span(name, **attrs):
    """``with telemetry.span("phase/name", k=v): ...`` records a span on
    exit (an exception annotates ``attrs.error`` and propagates)."""
    rec = _get()
    if rec is None:
        return _NULL
    return Span(rec, name, attrs)


def trace_span(name, header=None, **attrs):
    """Entry-point span: like :func:`span`, but always traced: it
    continues the trace in ``header`` (traceparent string or
    TraceContext), else the thread's active context, else mints a root.
    The no-op span when telemetry is disabled."""
    rec = _get()
    if rec is None:
        return _NULL
    parent = TraceContext.from_header(header) if header else current()
    ctx = parent.child() if parent is not None else TraceContext()
    return Span(rec, name, attrs, ctx=ctx)


def event(name, **attrs):
    """Record an instant event (``dur_ms`` null)."""
    rec = _get()
    if rec is not None:
        ctx = current()
        if ctx is not None:
            attrs.setdefault("trace_id", ctx.trace_id)
            attrs.setdefault("parent_id", ctx.span_id)
        rec.record("event", name, time.time(), None, attrs)


def record_span(name, dur_s, **attrs):
    """Record an already-measured duration as a span back-dated by
    ``dur_s``."""
    rec = _get()
    if rec is not None:
        _record_span(rec, name, time.time() - dur_s, dur_s, attrs)


def record_span_at(name, ts, dur_s, **attrs):
    """Record an already-measured span that began at ``ts`` (epoch s).
    ``attrs`` may name its ``trace_id``/``span_id``/``parent_id``
    (:func:`span_ids`), else the active context's are taken."""
    rec = _get()
    if rec is not None:
        _record_span(rec, name, ts, dur_s, attrs)


def _record_span(rec, name, ts, dur_s, attrs):
    ctx = current()
    if ctx is not None:
        attrs.setdefault("trace_id", ctx.trace_id)
        attrs.setdefault("parent_id", ctx.span_id)
    if "trace_id" in attrs:
        attrs.setdefault("span_id", os.urandom(8).hex())
    rec.record("span", name, ts, dur_s * 1000.0, attrs)


def span_ids():
    """``{"trace_id", "span_id", "parent_id"}`` of a span recorded once
    it ends (``record_span_at(..., **ids)``), minted now so that the
    spans inside it can name it as their ``parent_id``: a child of the
    active context, else a new root.  None when disabled."""
    if _get() is None:
        return None
    parent = current()
    ctx = parent.child() if parent is not None else TraceContext()
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id,
            "parent_id": ctx.parent_id}


def trace_root(name, export=True, **attrs):
    """Mint a root context for a long-lived scope and record an instant
    anchor span for it, so every child's ``parent_id`` resolves; with
    ``export`` the context goes on ``TFOS_TRACE_PARENT`` for this
    process's later records and its children.  None when disabled."""
    rec = _get()
    if rec is None:
        return None
    ctx = TraceContext()
    attrs.setdefault("trace_id", ctx.trace_id)
    attrs.setdefault("span_id", ctx.span_id)
    attrs.setdefault("parent_id", None)
    rec.record("span", name, time.time(), 0.0, attrs)
    if export:
        os.environ[TRACE_ENV] = ctx.to_header()
    return ctx


def recent(window_s=None):
    """The flight ring: this process's last records, oldest first,
    clipped to the trailing ``window_s`` seconds when given; empty when
    disabled."""
    rec = _get()
    if rec is None:
        return []
    with rec._lock:
        records = list(rec.ring)
    if window_s is not None:
        cutoff = time.time() - float(window_s)
        records = [r for r in records if r.get("ts", 0) >= cutoff]
    return records


def flush():
    """Flush this process's buffered records to the JSONL sink."""
    rec = _get()
    if rec is not None:
        rec.flush()


def run_dir(cluster_id):
    """The run's collection directory under ``TFOS_TELEMETRY_DIR``,
    which the driver's drain fills at shutdown; None when disabled."""
    base = os.environ.get(DIR_ENV)
    if not base:
        return None
    return os.path.join(base, f"run-{int(cluster_id) & 0xffffffff:x}")


def register_with(mgr):
    """Advertise this process's spool in the manager's KV (the drain
    channel), best effort: telemetry never takes a worker down."""
    rec = _get()
    if rec is None:
        return
    try:
        mgr.telemetry_register(os.path.abspath(rec.sink_dir))
    except Exception as e:  # noqa: BLE001 - the drain is best-effort
        logger.debug("telemetry spool registration failed: %s", e)


def read_spool(spool_dir):
    """``[(filename, jsonl_text), ...]`` for every ``*.jsonl`` file in a
    spool, each line a whole JSON record: a line a killed writer left
    truncated (or garbage) is dropped and counted, one warning a file.
    Never raises: the drain runs on live executors."""
    out = []
    try:
        names = sorted(os.listdir(spool_dir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        try:
            # a record cut inside a multi-byte character must not abort
            # the file
            with open(os.path.join(spool_dir, name), encoding="utf-8",
                      errors="replace") as f:
                raw = f.read()
        except OSError as e:
            logger.warning("telemetry drain: unreadable %s: %s", name, e)
            continue
        kept, skipped = [], 0
        for line in raw.splitlines():
            if not line.strip():
                continue
            try:
                json.loads(line)
            except ValueError:
                skipped += 1
                continue
            kept.append(line)
        if skipped:
            logger.warning("telemetry drain: skipped %d truncated/corrupt "
                           "line(s) in %s", skipped, name)
        if kept:
            out.append((name, "\n".join(kept) + "\n"))
    return out
