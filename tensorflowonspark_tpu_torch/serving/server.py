"""Serving frontend: in-process Client, stdlib HTTP endpoint, SLO stats.

Counterpart of ``tensorflowonspark_tpu/serving/server.py``: ``Server`` =
:class:`~.replicas.ReplicaPool` (supervised model replicas) +
:class:`~.batcher.MicroBatcher` (request coalescing) + :class:`SLOStats`
(latency percentiles, shed rate, device-batch sizes) +
:class:`DecodeStats` (TTFT and per-token gaps).  Every completed request
is recorded as a ``telemetry.SERVE_REQUEST`` span with ``queue_ms`` /
``batch_ms`` / ``device_ms`` attrs; every load-shed rejection is a
``telemetry.SERVE_SHED`` event.

Admission control: past ``TFOS_SERVE_QUEUE_MAX`` pending requests (or
``TFOS_DECODE_QUEUE_MAX`` outstanding sessions) ``predict``/``generate``
raise :class:`~.batcher.Overloaded`; the HTTP frontend maps it to
``503`` + ``Retry-After``.  Shed requests are rejected, never silently
dropped.  The console script ``tfos-serve-torch`` runs :func:`main`.

The pool is a :class:`~.replicas.ReplicaPool`, an
:class:`~.elastic.ElasticReplicaPool` (``elastic=``,
``logical_replicas=``: it degrades by resize, and admission shrinks with
its capacity) or a :class:`~.fabric.FabricRouter` (``fabric=``,
``fabric_hosts=``, ``replicas_per_host=``, ``autoscale=``: hosts of
worker replicas, session-affinity routing by ``route_id``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tensorflowonspark_tpu_torch.serving import batcher as _batcher
from tensorflowonspark_tpu_torch.serving.batcher import (
    MicroBatcher,
    Overloaded,
)
from tensorflowonspark_tpu_torch.serving.decode import sampling as _sampling
from tensorflowonspark_tpu_torch.serving.decode import scheduler as _decode
from tensorflowonspark_tpu_torch.serving.replicas import (
    ModelSpec,
    ReplicaPool,
)
from tensorflowonspark_tpu_torch.utils import metrics_registry, telemetry

logger = logging.getLogger(__name__)


def _pct(sorted_vals, q):
    """Nearest-rank percentile (same convention as scripts/trace_merge)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class SLOStats:
    """Thread-safe request/batch/shed counters + latency percentiles."""

    def __init__(self, sample_cap=100_000):
        self._lock = threading.Lock()
        self._cap = sample_cap
        self.total_ms = []
        self.queue_ms = []
        self.device_ms = []
        self.completed = 0
        self.shed = 0
        self.errors = 0
        self.batches = 0
        self.batch_rows = 0
        self.buckets = set()

    def observe_request(self, attrs):
        with self._lock:
            self.completed += 1
            if len(self.total_ms) < self._cap:
                self.total_ms.append(attrs["total_ms"])
                self.queue_ms.append(attrs["queue_ms"])
                self.device_ms.append(attrs["device_ms"])

    def observe_batch(self, batch, meta):
        del meta
        with self._lock:
            self.batches += 1
            self.batch_rows += batch.n_valid
            self.buckets.add(batch.bucket)

    def observe_shed(self):
        with self._lock:
            self.shed += 1

    def observe_error(self):
        with self._lock:
            self.errors += 1

    def summary(self):
        with self._lock:
            totals = sorted(self.total_ms)
            queues = sorted(self.queue_ms)
            devices = sorted(self.device_ms)
            completed, shed, errors = self.completed, self.shed, self.errors
            batches, rows = self.batches, self.batch_rows
            buckets = sorted(self.buckets)
        seen = completed + shed + errors
        return {
            "requests": seen,
            "completed": completed,
            "shed": shed,
            "errors": errors,
            "shed_rate": round(shed / seen, 4) if seen else 0.0,
            "p50_ms": round(_pct(totals, 0.50), 3),
            "p95_ms": round(_pct(totals, 0.95), 3),
            "p99_ms": round(_pct(totals, 0.99), 3),
            "mean_queue_ms": (round(sum(queues) / len(queues), 3)
                              if queues else 0.0),
            "mean_device_ms": (round(sum(devices) / len(devices), 3)
                               if devices else 0.0),
            "batches": batches,
            "mean_device_batch": (round(rows / batches, 2)
                                  if batches else 0.0),
            "buckets": buckets,
        }


class DecodeStats:
    """Thread-safe decode-session counters + TTFT / per-token
    percentiles (docs/serving.md "Autoregressive decode").

    TTFT (time to first token) and per-token gap are the two decode
    SLOs; total-latency percentiles alone hide a slow-start server
    behind a fast steady state and vice versa.
    """

    def __init__(self, sample_cap=100_000):
        self._lock = threading.Lock()
        self._cap = sample_cap
        self.ttft_ms = []
        self.token_ms = []
        self.completed = 0
        self.shed = 0
        self.errors = 0
        self.tokens = 0

    def observe_session(self, result):
        with self._lock:
            self.completed += 1
            self.tokens += len(result.get("tokens") or ())
            if result.get("ttft_ms") is not None \
                    and len(self.ttft_ms) < self._cap:
                self.ttft_ms.append(result["ttft_ms"])
            if len(self.token_ms) < self._cap:
                self.token_ms.extend(result.get("token_ms") or ())

    def observe_shed(self):
        with self._lock:
            self.shed += 1

    def observe_error(self):
        with self._lock:
            self.errors += 1

    def summary(self):
        with self._lock:
            ttft = sorted(self.ttft_ms)
            gaps = sorted(self.token_ms)
            completed, shed, errors = self.completed, self.shed, self.errors
            tokens = self.tokens
        seen = completed + shed + errors
        return {
            "sessions": seen,
            "completed": completed,
            "shed": shed,
            "errors": errors,
            "tokens": tokens,
            "ttft_p50_ms": round(_pct(ttft, 0.50), 3),
            "ttft_p99_ms": round(_pct(ttft, 0.99), 3),
            "tok_p50_ms": round(_pct(gaps, 0.50), 3),
            "tok_p99_ms": round(_pct(gaps, 0.99), 3),
        }


class Server:
    """An online model service over the cluster runtime.

    Usage (in-process)::

        spec = ModelSpec(export_dir=..., ckpt_dir=...)
        srv = Server(spec, num_replicas=2).start()
        row = srv.predict({"image": x})     # {tensor_name: ndarray}
        srv.stop()

    or over HTTP: ``serve_http(srv, port=8500)`` / the
    ``tfos-serve-torch`` CLI.  ``engine=`` reuses an existing LocalEngine
    (e.g. ``TFCluster.serve``); otherwise the server owns a fresh one
    sized to ``num_replicas``.
    """

    def __init__(self, spec, num_replicas=None, max_batch=None,
                 max_delay_ms=None, queue_max=None, engine=None, env=None,
                 request_timeout=None, decode_queue_max=None,
                 seq_axis=None, seq_cap=None, elastic=False,
                 logical_replicas=None, fabric=False, fabric_hosts=None,
                 replicas_per_host=None, autoscale=False):
        self.spec = spec
        self.stats = SLOStats()
        self.decode_stats = DecodeStats()
        self.request_timeout = (request_timeout
                                or _batcher.request_timeout_default())
        self.decode_queue_max = (decode_queue_max
                                 or _decode.queue_max_default())
        # decode admission shrinks with an elastic pool's capacity as the
        # batcher's queue bound does; 1.0 until the pool says otherwise
        self._decode_capacity = 1.0
        if fabric or fabric_hosts:
            from tensorflowonspark_tpu_torch.serving.fabric import (
                FabricRouter,
            )

            self.pool = FabricRouter(
                spec, num_hosts=fabric_hosts,
                replicas_per_host=replicas_per_host or 1,
                engine=engine, env=env,
                request_timeout=self.request_timeout,
                autoscale=autoscale)
        elif elastic or logical_replicas:
            from tensorflowonspark_tpu_torch.serving.elastic import (
                ElasticReplicaPool,
            )

            self.pool = ElasticReplicaPool(
                spec, num_replicas=num_replicas,
                logical_replicas=logical_replicas, engine=engine, env=env,
                request_timeout=self.request_timeout,
                on_capacity=self._on_capacity)
        else:
            self.pool = ReplicaPool(
                spec, num_replicas=num_replicas, engine=engine, env=env,
                request_timeout=self.request_timeout)
        self.batcher = MicroBatcher(
            self.pool.dispatch, max_batch=max_batch,
            max_delay_ms=max_delay_ms, queue_max=queue_max,
            observer=self._on_request, batch_observer=self._on_batch,
            on_shed=self._on_shed, seq_axis=seq_axis, seq_cap=seq_cap)
        self._session_ids = itertools.count(1)
        self._stopped = False

    # -- observers (batcher -> stats + telemetry + live metrics) ------------
    def _on_request(self, attrs):
        self.stats.observe_request(attrs)
        metrics_registry.inc("tfos_serve_requests_total", status="ok")
        metrics_registry.observe("tfos_serve_request_ms", attrs["total_ms"])
        span_attrs = dict(
            queue_ms=round(attrs["queue_ms"], 3),
            batch_ms=round(attrs["batch_ms"], 3),
            device_ms=round(attrs["device_ms"], 3),
            batch=attrs["batch"], bucket=attrs["bucket"])
        # version-tagged spans: trace_merge and /statusz split request
        # telemetry by the params version that answered (canary rollouts)
        if "version" in attrs:
            span_attrs["version"] = attrs["version"]
        if "replica" in attrs:
            span_attrs["replica"] = attrs["replica"]
        telemetry.record_span(
            telemetry.SERVE_REQUEST, attrs["total_ms"] / 1e3, **span_attrs)

    def _on_batch(self, batch, meta):
        self.stats.observe_batch(batch, meta)
        metrics_registry.inc("tfos_serve_batches_total")
        metrics_registry.inc("tfos_serve_batch_rows_total", batch.n_valid)

    def _on_shed(self, depth, limit):
        self.stats.observe_shed()
        metrics_registry.inc("tfos_serve_requests_total", status="shed")
        telemetry.event(telemetry.SERVE_SHED, depth=depth, limit=limit)

    def _on_capacity(self, frac, generation, degraded):
        """The elastic pool's capacity hook: declared degraded mode,
        admission shrinks with the pool and sheds stay explicit."""
        self.batcher.set_capacity(frac)
        self._decode_capacity = frac
        telemetry.event("serve/capacity", capacity=round(frac, 4),
                        generation=generation, degraded=degraded)

    # -- lifecycle ----------------------------------------------------------
    def start(self, timeout=180.0):
        self.pool.start(timeout=timeout)
        self.batcher.start()
        return self

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        self.batcher.close()
        self.pool.stop()
        telemetry.flush()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- request path -------------------------------------------------------
    def predict(self, example, timeout=None, trace=None):
        """Serve one example ({tensor_name: array-like}, no batch axis);
        returns the outputs row.  Raises Overloaded on load shed,
        TimeoutError past ``timeout`` (default TFOS_SERVE_TIMEOUT).

        ``trace`` is an optional W3C-traceparent string (or
        :class:`~..utils.telemetry.TraceContext`) linking this request
        into a caller's trace; without one a fresh root is minted
        (docs/telemetry.md "Causal tracing")."""
        with telemetry.trace_span(telemetry.SERVE_PREDICT, header=trace):
            req = self.batcher.submit(example)
            try:
                return req.result(timeout or self.request_timeout)
            except Overloaded:
                raise
            except Exception:
                self.stats.observe_error()
                metrics_registry.inc("tfos_serve_requests_total",
                                     status="error")
                raise

    def generate(self, prompt, max_tokens=None, eos_id=None, timeout=None,
                 temperature=None, top_k=None, top_p=None, seed=None,
                 trace=None, route_id=None):
        """One autoregressive decode session: ``prompt`` is a list of
        int token ids; returns ``{"tokens": [...], "ttft_ms", "token_ms"
        (per-token gaps), "total_ms", ...engine meta}``.

        ``route_id`` is an opaque session-affinity key: with a fabric
        pool, sessions sharing a route id land on the worker whose paged
        KV cache still holds their prefix blocks, and the result meta
        carries the routing outcome under ``"affinity"`` (hit, miss or
        fallback).  Other pools ignore it.

        ``trace`` optionally links the session into a caller's trace
        (W3C-traceparent string or TraceContext); the context is
        carried inside the dispatch blob so replica-side decode spans
        join the same tree.

        Sampling: ``temperature > 0`` switches the session from greedy
        argmax to seeded sampling (``top_k``/``top_p`` optional).  The
        seed is resolved HERE (random when unset) so the dispatch blob
        carries it: a failover replay re-draws the identical token
        stream (decode/sampling.py).  Out-of-range sampling values and
        invalid prompts raise ValueError (HTTP 400) before dispatch —
        an oversized prompt is a client error, never a replica-side
        crash or a shed.

        Admission control mirrors ``predict``: past
        ``TFOS_DECODE_QUEUE_MAX`` outstanding sessions, raises
        :class:`~.batcher.Overloaded` (HTTP maps it to 503 +
        Retry-After).  The session survives replica SIGKILL — the pool
        re-prefills it on a survivor, and the resolve-once ledger
        guarantees zero dropped / zero duplicated tokens.
        """
        if self.spec.decode is None:
            raise RuntimeError("spec has no decode engine; pass "
                               "ModelSpec(..., decode=DecodeSpec(...))")
        prompt = [int(t) for t in prompt]
        max_seq = self.spec.decode.cfg.max_seq
        if not prompt or len(prompt) > max_seq - 1:
            raise ValueError(
                f"prompt length {len(prompt)} not in [1, {max_seq - 1}] "
                f"(max_seq {max_seq})")
        if seed is None and temperature is not None and temperature > 0:
            seed = random.getrandbits(31)
        sampling = _sampling.make(temperature=temperature, top_k=top_k,
                                  top_p=top_p, seed=seed)
        with telemetry.trace_span(telemetry.SERVE_GENERATE, header=trace,
                                  prompt_len=len(prompt)):
            return self._generate_traced(prompt, max_tokens, eos_id,
                                         timeout, sampling, route_id)

    def _generate_traced(self, prompt, max_tokens, eos_id, timeout,
                         sampling, route_id=None):
        depth = self.pool.outstanding_sessions()
        limit = max(1, int(round(self.decode_queue_max
                                 * self._decode_capacity))) \
            if self._decode_capacity > 0 else 0
        if depth >= limit:
            self.decode_stats.observe_shed()
            metrics_registry.inc("tfos_decode_sessions_total", status="shed")
            telemetry.event(telemetry.DECODE_SHED, depth=depth, limit=limit)
            raise Overloaded(depth, limit,
                             retry_after=0.25 if self._decode_capacity < 1.0
                             else 0.1)
        ctx = telemetry.current()
        session = _decode.PendingSession(
            next(self._session_ids), prompt,
            max_tokens or (self.spec.decode.max_tokens
                           if self.spec.decode else None)
            or _decode.max_tokens_default(),
            self.spec.decode.eos_id if eos_id is None else eos_id,
            sampling=sampling,
            trace=ctx.to_header() if ctx is not None else None,
            route_id=None if route_id is None else str(route_id))
        self.pool.dispatch_session(session)
        try:
            out = session.result(timeout or self.request_timeout)
        except Overloaded:
            raise
        except Exception:
            self.pool.cancel_session(session.id)
            self.decode_stats.observe_error()
            metrics_registry.inc("tfos_decode_sessions_total",
                                 status="error")
            raise
        self.decode_stats.observe_session(out)
        metrics_registry.inc("tfos_decode_sessions_total", status="ok")
        metrics_registry.inc("tfos_decode_tokens_total",
                             len(out.get("tokens") or ()))
        if out.get("ttft_ms") is not None:
            metrics_registry.observe("tfos_decode_ttft_ms", out["ttft_ms"])
        for gap in out.get("token_ms") or ():
            metrics_registry.observe("tfos_decode_token_ms", gap)
        telemetry.record_span(
            telemetry.DECODE_SESSION, out["total_ms"] / 1e3,
            tokens=len(out.get("tokens") or ()),
            ttft_ms=out.get("ttft_ms"), replica=out.get("replica"))
        return out

    def client(self):
        return Client(self)

    def summary(self, include_replicas=False):
        """One JSON-able dict of SLO metrics (+ per-replica predictor
        stats when asked — a live round-trip to every replica)."""
        out = self.stats.summary()
        out["replicas"] = self.pool.live_replicas()
        out["versions"] = self.pool.versions()
        if self.spec.decode is not None:
            out["decode"] = self.decode_stats.summary()
        if include_replicas:
            out["replica_stats"] = self.pool.stats()
        if hasattr(self.pool, "describe"):
            out["pool"] = self.pool.describe()
        return out


class Client:
    """In-process client handle (the test-facing 'connection')."""

    def __init__(self, server):
        self._server = server

    def predict(self, example, timeout=None, trace=None):
        return self._server.predict(example, timeout=timeout, trace=trace)

    def generate(self, prompt, max_tokens=None, eos_id=None, timeout=None,
                 temperature=None, top_k=None, top_p=None, seed=None,
                 trace=None):
        return self._server.generate(prompt, max_tokens=max_tokens,
                                     eos_id=eos_id, timeout=timeout,
                                     temperature=temperature, top_k=top_k,
                                     top_p=top_p, seed=seed, trace=trace)


# ---------------------------------------------------------------------------
# HTTP frontend (stdlib http.server; one thread per connection)
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    server_version = "tfos-serve/0.1"

    def log_message(self, fmt, *args):  # route to logging, not stderr
        logger.debug("http: " + fmt, *args)

    def _reply(self, code, payload, headers=None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv = self.server.tfos_server
        if self.path == "/healthz":
            live = srv.pool.live_replicas()
            # an elastic pool below its logical capacity is alive and
            # degraded: still 200, with its generation and capacity
            degraded = (not live) or getattr(srv.pool, "degraded", False)
            body = {"status": "degraded" if degraded else "ok",
                    "replicas": live}
            if hasattr(srv.pool, "generation"):
                body["generation"] = srv.pool.generation
                body["capacity"] = round(srv.pool.capacity_frac, 4)
            self._reply(200 if live else 503, body)
        elif self.path == "/stats":
            self._reply(200, srv.summary())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        srv = self.server.tfos_server
        if self.path == "/v1/generate":
            self._do_generate(srv)
            return
        if self.path != "/v1/predict":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            inputs = payload.get("inputs")
            if not isinstance(inputs, dict) or not inputs:
                raise ValueError('body must be {"inputs": {name: values}}')
            example = {k: np.asarray(v) for k, v in inputs.items()}
        except (ValueError, TypeError) as e:
            self._reply(400, {"error": str(e)})
            return
        try:
            row = srv.predict(example,
                              trace=self.headers.get("traceparent"))
        except Overloaded as e:
            # explicit load shed: 503 + retry-after (docs/serving.md)
            self._reply(503, {"error": "overloaded",
                              "retry_after": round(e.retry_after, 3)},
                        headers={"Retry-After": f"{e.retry_after:.3f}"})
            return
        except TimeoutError as e:
            self._reply(504, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 - surface, don't crash
            self._reply(500, {"error": repr(e)})
            return
        self._reply(200, {
            "outputs": {k: np.asarray(v).tolist() for k, v in row.items()}
        })

    def _do_generate(self, srv):
        """POST /v1/generate: ``{"prompt": [ids], "max_tokens"?,
        "eos_id"?, "temperature"?, "top_k"?, "top_p"?, "seed"?,
        "route_id"?}`` -> the session result dict (docs/serving.md).
        ``route_id`` is the session-affinity key a fabric pool routes
        on.  Oversized prompts and out-of-range sampling knobs are
        client errors (400), never replica-side crashes."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            prompt = payload.get("prompt")
            if not isinstance(prompt, list) or not prompt:
                raise ValueError(
                    'body must be {"prompt": [token ids], ...}')
            prompt = [int(t) for t in prompt]
        except (ValueError, TypeError) as e:
            self._reply(400, {"error": str(e)})
            return
        try:
            out = srv.generate(prompt,
                               max_tokens=payload.get("max_tokens"),
                               eos_id=payload.get("eos_id"),
                               temperature=payload.get("temperature"),
                               top_k=payload.get("top_k"),
                               top_p=payload.get("top_p"),
                               seed=payload.get("seed"),
                               trace=self.headers.get("traceparent"),
                               route_id=payload.get("route_id"))
        except ValueError as e:
            # oversized/empty prompt, bad sampling range: client error
            self._reply(400, {"error": str(e)})
            return
        except Overloaded as e:
            self._reply(503, {"error": "overloaded",
                              "retry_after": round(e.retry_after, 3)},
                        headers={"Retry-After": f"{e.retry_after:.3f}"})
            return
        except TimeoutError as e:
            self._reply(504, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 - surface, don't crash
            self._reply(500, {"error": repr(e)})
            return
        self._reply(200, out)


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog is 5: a burst of concurrent clients
    # past it waits out a SYN retransmit (~1 s) before its connection
    request_queue_size = 128


def serve_http(server, host="127.0.0.1", port=8500, block=True):
    """Expose ``server`` over HTTP.  ``block=False`` runs the listener on
    a daemon thread and returns the ``ThreadingHTTPServer`` (tests use
    its ``.server_address`` for the ephemeral port)."""
    httpd = _HTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.tfos_server = server
    if block:
        httpd.serve_forever()
        return httpd
    t = threading.Thread(target=httpd.serve_forever,
                         name="tfos-serve-http", daemon=True)
    t.start()
    return httpd


# ---------------------------------------------------------------------------
# CLI (console entry point: tfos-serve-torch)
# ---------------------------------------------------------------------------

def build_parser():
    p = argparse.ArgumentParser(
        prog="tfos-serve-torch",
        description="Online inference serving for an exported model",
    )
    p.add_argument("--export_dir", default=None,
                   help="export directory (utils.checkpoint.export_model)")
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoint dir to hot-reload params from")
    p.add_argument("--signature_def_key", default=None,
                   help="module:function predict override")
    p.add_argument("--num_replicas", type=int, default=None,
                   help="model replicas (default $TFOS_SERVE_REPLICAS "
                        "or 2)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--max_batch", type=int, default=None)
    p.add_argument("--max_delay_ms", type=float, default=None)
    p.add_argument("--queue_max", type=int, default=None)
    p.add_argument("--elastic", action="store_true",
                   help="a pool that degrades by resize and re-grows "
                        "from live params")
    p.add_argument("--logical_replicas", type=int, default=None,
                   help="logical capacity for --elastic "
                        "(default: num_replicas)")
    p.add_argument("--fabric", action="store_true",
                   help="the serving fabric: hosts of worker replicas, "
                        "session-affinity routing")
    p.add_argument("--fabric_hosts", type=int, default=None,
                   help="fabric host processes (default $TFOS_FABRIC_HOSTS "
                        "or 2)")
    p.add_argument("--replicas_per_host", type=int, default=None,
                   help="a fabric host's workers at boot (default 1)")
    p.add_argument("--autoscale", action="store_true",
                   help="run the ServeAutoscaler over the fabric "
                        "(TFOS_SERVE_MIN/MAX_REPLICAS clamp a host)")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if not args.export_dir and not args.ckpt_dir:
        build_parser().error("--export_dir or --ckpt_dir is required")
    spec = ModelSpec(export_dir=args.export_dir, ckpt_dir=args.ckpt_dir,
                     predict=args.signature_def_key, device=args.device)
    server = Server(spec, num_replicas=args.num_replicas,
                    max_batch=args.max_batch,
                    max_delay_ms=args.max_delay_ms,
                    queue_max=args.queue_max,
                    elastic=args.elastic,
                    logical_replicas=args.logical_replicas,
                    fabric=args.fabric,
                    fabric_hosts=args.fabric_hosts,
                    replicas_per_host=args.replicas_per_host,
                    autoscale=args.autoscale)
    server.start()
    logger.info("serving on http://%s:%d (POST /v1/predict)",
                args.host, args.port)
    try:
        serve_http(server, host=args.host, port=args.port, block=True)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
