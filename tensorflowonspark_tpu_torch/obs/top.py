"""``tfos-top-torch``: a live per-node view of a cluster's ``/statusz``.

An own copy of ``tensorflowonspark_tpu/obs/top.py``.  Polls the
driver's ``ObsServer`` and prints one row a node (role, liveness, steps,
step time, rate, MFU, stall share, queue depth, respawns, serving
percentiles), redrawn with plain ANSI (it works over ssh, under
``watch`` and in CI logs); ``--once`` prints one snapshot and exits.

Usage::

    tfos-top-torch [--url http://127.0.0.1:9090] [--interval 2] [--once]
                   [--slo] [--health] [--deploy] [--pods]

``--url`` defaults to ``http://127.0.0.1:$TFOS_OBS_PORT``; ``--slo``
adds the objectives' pane (``obs.slo``), ``--health`` the watchtower's
(anomalies a node and the straggler table, ``obs.health``), ``--deploy``
the deploy loops' (rollout state, canary arms, verdicts;
``workloads.deploy_loop``) and ``--pods`` the serving fabric's (a row a
host: workers, queue depth, affinity hit rate; ``serving.fabric``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request

from tensorflowonspark_tpu_torch.utils import metrics_registry

CLEAR = "\x1b[H\x1b[2J"


def _s(entry):
    return entry.get("summary") or {}


def _num(v):
    if v is None:
        return "-"
    f = float(v)
    if f >= 10000:
        return f"{f / 1000.0:.1f}k"
    return str(int(f)) if f == int(f) else f"{f:.1f}"


def _pct(v):
    return "-" if v is None else f"{100.0 * float(v):.1f}"


def _secs(v):
    return "-" if v is None else f"{float(v):.1f}s"


def _rel(v):
    return "-" if v is None else f"{float(v):.2f}x"


def _serve(summary):
    p50, p99 = summary.get("serve_p50_ms"), summary.get("serve_p99_ms")
    if p50 is None and p99 is None:
        return "-"
    return f"{_num(p50)}/{_num(p99)}"


# (header, width, extractor) over a /statusz node entry
COLUMNS = (
    ("NODE", 14, lambda nid, e: nid),
    ("ROLE", 9, lambda nid, e: e.get("role") or "?"),
    ("UP", 4, lambda nid, e: "yes" if e.get("alive") else "DOWN"),
    ("SEEN", 6, lambda nid, e: _secs(e.get("last_seen_age_s"))),
    ("STEPS", 7, lambda nid, e: _num(_s(e).get("steps"))),
    ("STEP-MS", 8, lambda nid, e: _num(_s(e).get("step_ms_p50"))),
    ("ITEMS/S", 8, lambda nid, e: _num(_s(e).get("items_per_sec"))),
    ("MFU%", 6, lambda nid, e: _pct(_s(e).get("mfu"))),
    ("STALL%", 7, lambda nid, e: _pct(_s(e).get("stall_frac"))),
    ("QDEPTH", 7, lambda nid, e: _num(_s(e).get("queue_depth"))),
    ("RSPWN", 6, lambda nid, e: _num(_s(e).get("respawns"))),
    ("P50/P99", 12, lambda nid, e: _serve(_s(e))),
)


def _slo_target(row):
    pct = row.get("target_pct")
    if pct is None:
        return "-"
    thr = row.get("threshold_ms")
    return f"<{_num(thr)}ms" if thr is not None else f"{pct:g}%"


def _slo_current(row):
    cur = row.get("current")
    if cur is None:
        return "-"
    return f"{_num(cur)}ms" if row.get("kind") == "latency" else _pct(cur)


def _slo_state(row):
    if row.get("burn") is None:
        return "no-data"
    return "BREACH" if row.get("breaching") else "ok"


# (header, width, extractor) over one /statusz "slo" row
SLO_COLUMNS = (
    ("OBJECTIVE", 20, lambda r: r.get("name", "?")),
    ("KIND", 13, lambda r: r.get("kind", "?")),
    ("TARGET", 8, _slo_target),
    ("CURRENT", 10, _slo_current),
    ("BURN", 7, lambda r: _num(r.get("burn"))),
    ("STATE", 9, _slo_state),
)

# (header, width, extractor) over a /statusz node entry
HEALTH_COLUMNS = (
    ("NODE", 14, lambda nid, e: nid),
    ("HEALTH", 9, lambda nid, e: _s(e).get("health") or "-"),
    ("ANOMALIES", 10, lambda nid, e: _num(_s(e).get("health_anomalies"))),
    ("GRAD-NORM", 10, lambda nid, e: _num(_s(e).get("grad_norm"))),
)

# (header, width, extractor) over one stragglers "nodes" row
STRAGGLER_COLUMNS = (
    ("NODE", 14, lambda r: r.get("node", "?")),
    ("P50-MS", 8, lambda r: _num(r.get("p50_ms"))),
    ("STEPS", 7, lambda r: _num(r.get("steps"))),
    ("REL", 6, lambda r: _rel(r.get("rel"))),
)


def _header(columns):
    return " ".join(h.ljust(w) for h, w, _ in columns).rstrip()


def _row(columns, *args):
    return " ".join(str(fn(*args))[:w].ljust(w)
                    for _, w, fn in columns).rstrip()


def render(status):
    """One ``/statusz`` snapshot as the table's text (no ANSI)."""
    cl = status.get("cluster") or {}
    lines = [f"tfos-top — cluster {cl.get('id', '?')} "
             f"epoch={cl.get('epoch', '?')} "
             f"restarts={cl.get('restarts_used', 0)}/{cl.get('restarts', 0)} "
             f"nodes={len(status.get('nodes') or {})}"]
    feeds = status.get("feeds") or {}
    if feeds:
        lines.append("feed ledger: " + " ".join(
            f"{f}:{n}" for f, n in sorted(feeds.items())))
    lines += ["", _header(COLUMNS)]
    for nid, ent in sorted((status.get("nodes") or {}).items()):
        lines.append(_row(COLUMNS, nid, ent))
    return "\n".join(lines) + "\n"


def render_slo(status):
    """The ``--slo`` pane: one row an objective."""
    rows = status.get("slo") or []
    lines = ["", "slo burn (obs/slo.py):"]
    if not rows:
        lines.append("  (no objectives reported)")
    else:
        lines.append(_header(SLO_COLUMNS))
        lines += [_row(SLO_COLUMNS, row) for row in rows]
    return "\n".join(lines) + "\n"


def render_health(status):
    """The ``--health`` pane: each node's watchtower state and the
    driver's straggler table."""
    lines = ["", "health (obs/health.py):"]
    rows = [(nid, ent)
            for nid, ent in sorted((status.get("nodes") or {}).items())
            if _s(ent).get("health") is not None]
    if rows:
        lines.append(_header(HEALTH_COLUMNS))
        lines += [_row(HEALTH_COLUMNS, nid, ent) for nid, ent in rows]
    else:
        lines.append("  (no health reports)")
    st = status.get("stragglers")
    if st:
        lines.append(f"stragglers: skew={_rel(st.get('skew'))} "
                     f"slowest={st.get('slowest', '?')} "
                     f"fastest={st.get('fastest', '?')}")
        lines.append(_header(STRAGGLER_COLUMNS))
        lines += [_row(STRAGGLER_COLUMNS, r) for r in st.get("nodes") or []]
    else:
        lines.append("stragglers: (not enough per-node step data)")
    return "\n".join(lines) + "\n"


# (header, width, extractor) over one /statusz "pods" row (a fabric host)
PODS_COLUMNS = (
    ("HOST", 6, lambda r: f"{r.get('router', 0)}/{r.get('host', '?')}"),
    ("UP", 4, lambda r: "yes" if r.get("alive") else "DOWN"),
    ("PID", 8, lambda r: _num(r.get("pid"))),
    ("REPLICAS", 9, lambda r: _num(r.get("replicas"))),
    ("QDEPTH", 7, lambda r: _num(r.get("queue_depth"))),
    ("VERSION", 8, lambda r: _num(r.get("version"))),
    ("AFF-HIT%", 9, lambda r: _pct(r.get("affinity_hit_rate"))),
)


def render_pods(status):
    """The ``--pods`` pane: a row a serving-fabric host."""
    lines = ["", "pods (serving/fabric/):"]
    rows = status.get("pods") or []
    if not rows:
        lines.append("  (no fabric routers)")
    else:
        lines.append(_header(PODS_COLUMNS))
        lines += [_row(PODS_COLUMNS, row) for row in rows]
    return "\n".join(lines) + "\n"


def render_deploy(status):
    """The ``--deploy`` pane: each deploy loop's rollout state, its
    canary arms' outcomes and its last verdict."""
    lines = ["", "deploy (workloads/deploy_loop.py):"]
    rows = status.get("deploy") or []
    if not rows:
        lines.append("  (no deployment loops)")
    for row in rows:
        canary = row.get("canary") or {}
        head = (f"  {row.get('ckpt_dir', '?')}: {row.get('state', '?')} "
                f"wm={row.get('watermark', '-')} "
                f"cand={row.get('candidate', '-')} "
                f"promoted={row.get('promotions', 0)} "
                f"rolled_back={row.get('rollbacks', 0)}")
        if canary:
            head += (f" arm={canary.get('replicas')}"
                     f"@{canary.get('pct', '?')}%")
        if row.get("burn_remaining_s") is not None:
            head += f" burn={row['burn_remaining_s']}s"
        lines.append(head)
        for arm, st in sorted((row.get("stats") or {}).items()):
            lines.append(f"    {arm}: n={st.get('n', 0)} "
                         f"errors={st.get('errors', 0)} "
                         f"p50={_num(st.get('p50_ms'))}ms "
                         f"p95={_num(st.get('p95_ms'))}ms")
        last = row.get("last_verdict")
        if last:
            why = "; ".join(last.get("reasons") or []) or "clean"
            lines.append(f"    last: {last.get('verdict', '?')} "
                         f"step={last.get('step', '?')} ({why})")
    return "\n".join(lines) + "\n"


def fetch_statusz(url, timeout=5):
    """GET ``<url>/statusz``, parsed; raises URLError or ValueError."""
    with urllib.request.urlopen(url.rstrip("/") + "/statusz",
                                timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8"))


def build_parser():
    p = argparse.ArgumentParser(
        prog="tfos-top-torch",
        description="live per-node view of a cluster's /statusz")
    port = os.environ.get(metrics_registry.PORT_ENV)
    p.add_argument("--url",
                   default=f"http://127.0.0.1:{port}" if port else None,
                   help="the obs endpoint (default: "
                        "http://127.0.0.1:$TFOS_OBS_PORT)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh period, seconds (default 2)")
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit")
    p.add_argument("--slo", action="store_true",
                   help="add the SLO pane (objective, current, burn)")
    p.add_argument("--health", action="store_true",
                   help="add the health pane (anomalies, stragglers)")
    p.add_argument("--deploy", action="store_true",
                   help="add the deploy pane (rollout state, canary arms, "
                        "verdicts)")
    p.add_argument("--pods", action="store_true",
                   help="add the pods pane (fabric hosts: workers, queue "
                        "depth, affinity hit rate)")
    return p


def main(argv=None, out=None):
    out = out or sys.stdout
    args = build_parser().parse_args(argv)
    if not args.url:
        print("tfos-top-torch: no --url and TFOS_OBS_PORT is unset",
              file=sys.stderr)
        return 2
    while True:
        try:
            status = fetch_statusz(args.url)
        except (urllib.error.URLError, OSError, ValueError) as e:
            if args.once:
                print(f"tfos-top-torch: {args.url} unreachable: {e}",
                      file=sys.stderr)
                return 2
            out.write(f"{CLEAR}tfos-top-torch: {args.url} unreachable "
                      f"({e}); retrying...\n")
            out.flush()
            time.sleep(args.interval)
            continue
        text = render(status)
        if args.slo:
            text += render_slo(status)
        if args.health:
            text += render_health(status)
        if args.deploy:
            text += render_deploy(status)
        if args.pods:
            text += render_pods(status)
        out.write(text if args.once else CLEAR + text)
        out.flush()
        if args.once:
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
