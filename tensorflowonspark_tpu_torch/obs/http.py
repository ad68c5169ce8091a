"""Driver-side observability endpoint: /metrics /healthz /statusz /slo.

An own copy of ``tensorflowonspark_tpu/obs/http.py``.  ``ObsServer``
polls every cluster node's manager KV for the registry snapshots its
processes published (``TFManager.obs_snapshots``) and for the node's
heartbeat, merges them with the driver's own registry and serves:

- ``GET /metrics``: Prometheus text, every series labelled with its
  ``node`` (``driver`` for the driver's own);
- ``GET /healthz``: 200 and ``ok`` while every heartbeat is fresh and no
  node reports a health anomaly, else 503 with ``unhealthy`` (a stale
  heartbeat) or ``degraded`` (an anomaly);
- ``GET /statusz``: the cluster (epoch, restarts, the feed ledger), one
  summary a node (``node_summary``), the straggler table, the SLO
  report, the driver's supervised actors (``actors``: a row a member,
  ``actors.runtime.actor_table``), the elastic serving pools
  (``pools``), the serving fabric's hosts (``pods``), the deploy loops
  (``deploy``) and the data service's rollup (``data``): what
  ``tfos-top-torch`` renders;
- ``GET /slo``: the objectives evaluated afresh (``obs.slo``);
- ``POST /profilez?node=&ms=`` and ``POST /flightz?node=``: a directive
  to the node's publisher, answered with its ack (the capture's path),
  or 202 while the ack has not come.

Nothing starts unless ``TFOS_OBS_PORT`` is set (0 binds an ephemeral
port, ``server.port``).  It binds loopback unless ``TFOS_OBS_HOST``
says otherwise; the GETs read only, the POSTs only write a capture on
the node.  Stdlib only: importing it initialises no CUDA.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import socket as _socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tensorflowonspark_tpu_torch import manager as tfmanager
from tensorflowonspark_tpu_torch.obs import health as _health
from tensorflowonspark_tpu_torch.obs import slo as _slo
from tensorflowonspark_tpu_torch.utils import metrics_registry

logger = logging.getLogger(__name__)

HOST_ENV = "TFOS_OBS_HOST"


def _metric_total(snap, name):
    """A counter's series summed, or None when absent."""
    ent = (snap or {}).get(name)
    if not ent:
        return None
    return sum(s.get("value", 0.0) for s in ent.get("series", ()))


def _metric_gauge(snap, name):
    """A gauge's first series value, or None when absent."""
    ent = (snap or {}).get(name)
    if not ent or not ent.get("series"):
        return None
    return ent["series"][0].get("value")


def _metric_hist(snap, name):
    """A histogram's first series, or None when absent."""
    ent = (snap or {}).get(name)
    if not ent or not ent.get("series"):
        return None
    s = ent["series"][0]
    return s if "count" in s else None


def _round(v, nd=3):
    return None if v is None else round(float(v), nd)


def _quantiles(out, snap, name, keys, nd=3):
    h = _metric_hist(snap, name)
    if h:
        for key, q in keys:
            out[key] = _round(metrics_registry.quantile(h, q), nd)
    return h


def node_summary(snap):
    """One node's key numbers, as ``/statusz`` ships them; a subsystem
    the node has not reported leaves its keys out."""
    out = {"steps": _metric_total(snap, "tfos_train_steps_total")}
    _quantiles(out, snap, "tfos_train_step_ms",
               (("step_ms_p50", 0.5), ("step_ms_p99", 0.99)))
    out["items_per_sec"] = _round(
        _metric_gauge(snap, "tfos_train_items_per_sec"))
    out["mfu"] = _round(_metric_gauge(snap, "tfos_train_mfu"), 4)
    out["stall_frac"] = _round(
        _metric_gauge(snap, "tfos_train_infeed_stall_frac"), 4)
    ring = _metric_gauge(snap, "tfos_feed_ring_bytes")
    out["queue_depth"] = (ring if ring is not None
                          else _metric_gauge(snap, "tfos_feed_queue_depth"))
    out["records"] = (_metric_total(snap, "tfos_feed_records_total")
                      or _metric_total(snap, "tfos_data_records_total"))
    out["respawns"] = _metric_total(snap, "tfos_engine_respawns_total")
    if _quantiles(out, snap, "tfos_serve_request_ms",
                  (("serve_p50_ms", 0.5), ("serve_p99_ms", 0.99))):
        sq = _metric_gauge(snap, "tfos_serve_queue_depth")
        if sq is not None:
            out["queue_depth"] = sq
    gen = _metric_gauge(snap, "tfos_serve_pool_generation")
    if gen is not None:
        out["pool_generation"] = gen
        out["pool_degraded"] = _metric_gauge(snap,
                                             "tfos_serve_pool_degraded")
        _quantiles(out, snap, "tfos_serve_resize_seconds",
                   (("resize_p99_s", 0.99),), nd=4)
    ha = _metric_total(snap, "tfos_health_anomalies_total")
    if ha:
        out["health_anomalies"] = ha
    hs = _metric_gauge(snap, "tfos_health_status")
    if hs is not None:
        out["health"] = "degraded" if hs else "ok"
    gn = _metric_gauge(snap, "tfos_health_grad_norm")
    if gn is not None:
        out["grad_norm"] = _round(gn, 4)
    skew = _metric_gauge(snap, "tfos_node_skew")
    if skew is not None:
        out["node_skew"] = _round(skew, 3)
    if _quantiles(out, snap, "tfos_decode_ttft_ms",
                  (("decode_ttft_p99_ms", 0.99),)):
        out["decode_tokens"] = _metric_total(snap,
                                             "tfos_decode_tokens_total")
        occ = _metric_gauge(snap, "tfos_decode_slot_occupancy")
        if occ is not None:
            out["decode_slots_busy"] = occ
        hits = _metric_total(snap, "tfos_decode_prefix_hits")
        if hits:
            out["decode_prefix_hits"] = hits
        blocks = _metric_gauge(snap, "tfos_decode_blocks_in_use")
        if blocks is not None:
            out["decode_blocks_in_use"] = blocks
        acc = _metric_gauge(snap, "tfos_decode_spec_accept")
        if acc is not None:
            out["decode_spec_accept"] = _round(acc, 4)
    return {k: v for k, v in out.items() if v is not None}


# the data service's rollup (/statusz "data"): counters summed over
# every process, gauges summed or the largest reporter's
_DATA_COUNTERS = (
    ("splits_posted", "tfos_data_splits_posted_total"),
    ("splits_claimed", "tfos_data_splits_claimed_total"),
    ("splits_served", "tfos_data_splits_served_total"),
    ("splits_requeued", "tfos_data_splits_requeued_total"),
    ("dup_chunks", "tfos_data_split_dup_chunks_total"),
    ("records", "tfos_data_records_total"),
    ("cache_hits", "tfos_data_cache_hits_total"),
    ("cache_misses", "tfos_data_cache_misses_total"),
    ("cache_spilled", "tfos_data_cache_spilled_total"),
)
_DATA_SUM_GAUGES = (
    ("cache_blocks", "tfos_data_cache_blocks"),
    ("cache_bytes", "tfos_data_cache_bytes"),
)
_DATA_MAX_GAUGES = (
    ("split_queue_depth", "tfos_data_split_queue_depth"),
    ("workers", "tfos_data_workers"),
)


def data_summary(snaps):
    """The data service's rollup over every snapshot, or None when no
    process reported a split, cache or worker metric.  The port runs no
    data service (ROADMAP.md queue 1, item 17), so its clusters report
    none."""
    out = {}
    for table, reader, combine in (
            (_DATA_COUNTERS, _metric_total, sum),
            (_DATA_SUM_GAUGES, _metric_gauge, sum),
            (_DATA_MAX_GAUGES, _metric_gauge, max)):
        for key, name in table:
            vals = [v for v in (reader(s, name) for s in snaps)
                    if v is not None]
            if vals:
                out[key] = combine(vals)
    if set(out) <= {"records"}:
        return None
    return out


class ObsServer:
    """The endpoint over ``cluster`` (a ``TFCluster``, or None for the
    driver's registry alone)."""

    def __init__(self, cluster=None, port=None, host=None, interval=None):
        self.cluster = cluster
        if port is None:
            port = int(os.environ.get(metrics_registry.PORT_ENV, "0") or 0)
        self._req_port = int(port)
        self.host = host or os.environ.get(HOST_ENV) or "127.0.0.1"
        self.interval = (metrics_registry.interval() if interval is None
                         else float(interval))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._nodes = {}  # node_id -> the latest payload and poll data
        self._mgrs = {}   # (host, executor_id) -> manager proxy
        self._httpd = None
        self._threads = []
        self._ctl_seq = 0
        self.slo = _slo.Engine()

    def start(self):
        httpd = ThreadingHTTPServer((self.host, self._req_port), _Handler)
        httpd.daemon_threads = True
        httpd.obs = self
        self._httpd = httpd
        for target, name in ((httpd.serve_forever, "tfos-obs-http"),
                             (self._poll_loop, "tfos-obs-poll")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        logger.info("obs: serving /metrics /healthz /statusz /slo (+POST "
                    "/profilez /flightz) on %s", self.url)
        return self

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def stop(self):
        self._stop.set()
        if self._httpd is not None:
            try:
                self._httpd.shutdown()
                self._httpd.server_close()
            except Exception:  # noqa: BLE001 - teardown
                pass
        for t in self._threads:
            t.join(timeout=5)
        self._mgrs.clear()

    # -- polling the nodes

    def _manager_for(self, meta):
        key = (meta["host"], meta["executor_id"])
        mgr = self._mgrs.get(key)
        if mgr is not None:
            return mgr
        addr = tuple(meta["addr"])
        candidates = [addr]
        if addr[0] not in ("127.0.0.1", "localhost"):
            candidates.append(("127.0.0.1", addr[1]))
        old = _socket.getdefaulttimeout()
        _socket.setdefaulttimeout(5)
        try:
            for cand in candidates:
                try:
                    mgr = tfmanager.connect(cand,
                                            bytes.fromhex(meta["authkey"]))
                except Exception:  # noqa: BLE001 - try the next address
                    continue
                self._mgrs[key] = mgr
                return mgr
        finally:
            _socket.setdefaulttimeout(old)
        return None

    def _poll_node(self, meta):
        node_id = f"{meta['job_name']}-{meta['task_index']}"
        mgr = self._manager_for(meta)
        if mgr is None:
            return
        try:
            payloads = mgr.obs_snapshots()
            hb_age = tfmanager.heartbeat_age(mgr)
        except Exception:  # noqa: BLE001 - reconnect at the next round
            self._mgrs.pop((meta["host"], meta["executor_id"]), None)
            return
        now = time.time()
        with self._lock:
            # the node (the heartbeat's owner), then every publisher
            # behind its manager, by published id
            ent = self._nodes.setdefault(node_id, {"node_id": node_id})
            ent.update(role=meta["job_name"],
                       executor_id=meta["executor_id"], host=meta["host"],
                       heartbeat_age_s=hb_age, polled_ts=now)
            for nid, payload in payloads.items():
                if not isinstance(payload, dict):
                    continue
                e = self._nodes.setdefault(nid, {"node_id": nid})
                e.update(role=payload.get("role", e.get("role")),
                         last_seen=payload.get("ts"),
                         metrics=payload.get("metrics"), polled_ts=now)
                e.setdefault("executor_id", meta["executor_id"])
                e.setdefault("host", meta["host"])
                if nid == node_id:
                    e["heartbeat_age_s"] = hb_age

    def poll_once(self):
        """One sweep over the nodes, then the SLO evaluation and the
        straggler analysis over what it sees."""
        for meta in list(getattr(self.cluster, "cluster_info", ()) or ()):
            if self._stop.is_set():
                return
            self._poll_node(meta)
        self.slo.step(self._all_snapshots())
        _health.straggler_report(self._node_entries())

    def _all_snapshots(self):
        snaps = [metrics_registry.snapshot()]
        snaps += [e["metrics"] for e in self._node_entries().values()
                  if e.get("metrics")]
        return [s for s in snaps if s]

    def _poll_loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 - keep serving
                logger.debug("obs poll error: %s", e)
            self._stop.wait(self.interval)

    # -- the control plane

    def _meta_for_node(self, node_id):
        """The node meta whose manager reaches ``node_id``: its own, or
        that of the executor it last published through."""
        metas = list(getattr(self.cluster, "cluster_info", ()) or ())
        for meta in metas:
            if f"{meta['job_name']}-{meta['task_index']}" == str(node_id):
                return meta
        ent = self._node_entries().get(str(node_id))
        if ent is not None and ent.get("executor_id") is not None:
            for meta in metas:
                if meta["executor_id"] == ent["executor_id"]:
                    return meta
        return None

    def request_control(self, node_id, directive, wait_s=None):
        """Post ``directive`` to the node and wait for the ack of its
        sequence number.  The result carries ``code``: 200 (ack in hand;
        its ``ok`` False means the node ran it degraded), 202 (no ack
        within ``wait_s``; the node still runs it), 404 (unknown node)
        or 502 (manager unreachable)."""
        node_id = str(node_id)
        meta = self._meta_for_node(node_id)
        if meta is None:
            return {"ok": False, "code": 404, "node": node_id,
                    "error": f"unknown node {node_id!r}"}
        mgr = self._manager_for(meta)
        if mgr is None:
            return {"ok": False, "code": 502, "node": node_id,
                    "error": "node manager unreachable"}
        with self._lock:
            self._ctl_seq += 1
            seq = self._ctl_seq
        directive = dict(directive, seq=seq, ts=time.time())
        try:
            mgr.obs_control_post(node_id, directive)
        except Exception as e:  # noqa: BLE001 - the manager died
            self._mgrs.pop((meta["host"], meta["executor_id"]), None)
            return {"ok": False, "code": 502, "node": node_id,
                    "error": f"directive post failed: {e}"}
        if wait_s is None:
            # a directive is served once a publish tick: two ticks and
            # the capture's window, at least 15 s (a first capture
            # starts the profiler) and at most 75 s
            wait_s = min(max(2.0 * self.interval + 3.0
                             + float(directive.get("ms") or 0) / 1000.0,
                             15.0), 75.0)
        deadline = time.time() + max(float(wait_s), 0.0)
        while time.time() < deadline and not self._stop.is_set():
            try:
                ack = mgr.obs_control_result(node_id)
            except Exception:  # noqa: BLE001 - retry until the deadline
                ack = None
            if isinstance(ack, dict) and ack.get("seq") == seq:
                return dict(ack, code=200)
            time.sleep(min(0.05, self.interval))
        return {"ok": None, "code": 202, "node": node_id, "seq": seq,
                "accepted": True,
                "error": f"no ack within {wait_s:.1f}s (directive still "
                         f"queued; the node serves it on its next tick)"}

    # -- the endpoints' bodies

    def _node_entries(self):
        with self._lock:
            return {nid: dict(e) for nid, e in self._nodes.items()}

    def render_metrics(self):
        pairs = []
        driver = metrics_registry.snapshot()
        if driver:
            pairs.append(({"node": "driver"}, driver))
        for nid, ent in sorted(self._node_entries().items()):
            if ent.get("metrics"):
                pairs.append(({"node": nid}, ent["metrics"]))
        return metrics_registry.render_text(pairs)

    def render_healthz(self):
        stale = tfmanager.stale_after()
        now = time.time()
        nodes, healthy, degraded = {}, True, False
        for nid, ent in sorted(self._node_entries().items()):
            hb, seen = ent.get("heartbeat_age_s"), ent.get("last_seen")
            alive = hb is None or hb < stale
            healthy = healthy and alive
            nodes[nid] = {"alive": alive, "heartbeat_age_s": _round(hb),
                          "publish_age_s": _round(now - seen) if seen
                          else None}
            anomalies = _health.snapshot_anomaly_total(ent.get("metrics"))
            if anomalies:
                degraded = True
                nodes[nid]["anomalies"] = anomalies
        # the driver's own registry too (a monitor in the driver)
        if _health.snapshot_anomaly_total(metrics_registry.snapshot()):
            degraded = True
        status = ("unhealthy" if not healthy
                  else "degraded" if degraded else "ok")
        return {"status": status, "nodes": nodes}

    def render_statusz(self):
        cluster = self.cluster
        now = time.time()
        out = {"ts": now, "url": self.url}
        if cluster is not None:
            meta = getattr(cluster, "meta", {}) or {}
            cid = meta.get("id")
            out["cluster"] = {
                "id": f"{cid & 0xffffffff:x}" if cid is not None else None,
                "epoch": meta.get("epoch"),
                "num_executors": meta.get("num_executors"),
                "restarts": getattr(cluster, "restarts", None),
                "restarts_used": getattr(cluster, "_restarts_used", None),
            }
            ledger = getattr(getattr(cluster, "server", None), "_feeds",
                             None)
            feeds = ledger.counts() if ledger is not None else None
            if feeds:
                out["feeds"] = feeds
        stale = tfmanager.stale_after()
        nodes = {}
        for nid, ent in sorted(self._node_entries().items()):
            seen, hb = ent.get("last_seen"), ent.get("heartbeat_age_s")
            nodes[nid] = {
                "role": ent.get("role"),
                "executor_id": ent.get("executor_id"),
                "host": ent.get("host"),
                "alive": hb is None or hb < stale,
                "heartbeat_age_s": _round(hb),
                "last_seen_age_s": _round(now - seen) if seen else None,
                "summary": node_summary(ent.get("metrics")),
            }
        driver = metrics_registry.snapshot()
        if driver:
            nodes["driver"] = {"role": "driver", "alive": True,
                               "summary": node_summary(driver)}
        out["nodes"] = nodes
        strag = _health.straggler_report(self._node_entries(), emit=False)
        if strag:
            out["stragglers"] = strag
        rep = self.slo.report()
        if rep.get("objectives"):
            out["slo"] = rep["objectives"]
        # the supervised actors: a row a member of every live
        # ActorSystem of this process (imported lazily: nothing of the
        # actors loads unless a system was spawned)
        try:
            from tensorflowonspark_tpu_torch.actors.runtime import (
                actor_table,
            )

            rows = actor_table()
        except Exception:  # noqa: BLE001 - actors tearing down
            rows = []
        if rows:
            out["actors"] = rows
        # the serving tier's tables, imported as lazily: the elastic
        # pools (generation, capacity, assignments), the fabric's hosts
        # and the deploy loops (rollout state, watermark, canary arms)
        for key, module, name in (
                ("pools", "serving.elastic", "pool_table"),
                ("pods", "serving.fabric.router", "fabric_table"),
                ("deploy", "workloads.deploy_loop", "deploy_table")):
            try:
                rows = getattr(importlib.import_module(
                    f"tensorflowonspark_tpu_torch.{module}"), name)()
            except Exception:  # noqa: BLE001 - a table tearing down
                rows = []
            if rows:
                out[key] = rows
        snaps = [ent.get("metrics")
                 for ent in self._node_entries().values()]
        if driver:
            snaps.append(driver)
        data = data_summary(snaps)
        if data:
            out["data"] = data
        return out

    def render_slo(self):
        """The objectives evaluated afresh over everything in view."""
        return self.slo.step(self._all_snapshots())


class _Handler(BaseHTTPRequestHandler):
    server_version = "tfos-obs/1"

    def log_message(self, fmt, *args):  # scrapes stay out of the log
        logger.debug("obs http: " + fmt, *args)

    def _reply(self, code, body, ctype):
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, code, doc):
        self._reply(code, json.dumps(doc, indent=1), "application/json")

    def do_GET(self):  # noqa: N802 - http.server API
        obs = self.server.obs
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._reply(200, obs.render_metrics(),
                            "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                h = obs.render_healthz()
                self._json(200 if h["status"] == "ok" else 503, h)
            elif path == "/statusz":
                self._json(200, obs.render_statusz())
            elif path == "/slo":
                self._json(200, obs.render_slo())
            elif path in ("/profilez", "/flightz"):
                self._reply(405, "profilez/flightz are POST verbs "
                                 "(POST /profilez?node=<id>&ms=<window>)",
                            "text/plain")
            else:
                self._reply(404, "not found: try /metrics /healthz "
                                 "/statusz /slo (POST /profilez /flightz)",
                            "text/plain")
        except Exception as e:  # noqa: BLE001 - the server lives on
            self._reply(500, f"obs error: {e}", "text/plain")

    def do_POST(self):  # noqa: N802 - http.server API
        obs = self.server.obs
        path, _, query = self.path.partition("?")
        params = urllib.parse.parse_qs(query)

        def q(name, default=None):
            return (params.get(name) or [default])[0]

        try:
            if path not in ("/profilez", "/flightz"):
                self._reply(404, "not found: POST /profilez /flightz",
                            "text/plain")
                return
            node = q("node")
            if not node:
                self._reply(400, "missing ?node=<node_id> (ids as shown "
                                 "on /statusz)", "text/plain")
                return
            wait_raw = q("wait_s")
            if path == "/profilez":
                directive = {"cmd": "profile", "ms": int(q("ms", "1000"))}
            else:
                directive = {"cmd": "flight", "reason": q("reason")}
            res = obs.request_control(
                node, directive, wait_s=float(wait_raw) if wait_raw
                else None)
            self._json(res.pop("code", 200), res)
        except ValueError as e:
            self._reply(400, f"bad parameter: {e}", "text/plain")
        except Exception as e:  # noqa: BLE001 - the server lives on
            self._reply(500, f"obs error: {e}", "text/plain")


def start_for_cluster(cluster):
    """The cluster's endpoint, started, when ``TFOS_OBS_PORT`` is set;
    None otherwise (or when the port does not bind)."""
    raw = os.environ.get(metrics_registry.PORT_ENV)
    if raw is None:
        return None
    try:
        port = int(raw)
    except ValueError:
        logger.warning("obs: %s=%r is not a port; metrics plane disabled",
                       metrics_registry.PORT_ENV, raw)
        return None
    try:
        return ObsServer(cluster, port=port).start()
    except OSError as e:
        logger.warning("obs: could not bind %s:%s (%s); metrics plane off",
                       os.environ.get(HOST_ENV, "127.0.0.1"), port, e)
        return None
