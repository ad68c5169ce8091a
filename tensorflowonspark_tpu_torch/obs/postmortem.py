"""``tfos-postmortem-torch``: flight dumps assembled into a report.

An own copy of ``tensorflowonspark_tpu/obs/postmortem.py``.  Walks a
telemetry tree (a drained run directory, or ``TFOS_TELEMETRY_DIR``) for
the flight recorder's ``flight-*.json`` dumps and the ``*.jsonl``
spools, and prints, for the newest dump (every one with ``--all``): the
trigger, the victim and the reason, the work in flight, each node's
records in the trailing window and the victim's last records.  A dump
or spool line that a killed writer left truncated is skipped and
counted.

Usage::

    tfos-postmortem-torch --dir TELEMETRY_DIR [--window 30] [--all]
    python -m tensorflowonspark_tpu_torch.obs.postmortem --dir ...
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from tensorflowonspark_tpu_torch.utils import telemetry


def load_dumps(root):
    """``(dumps oldest first, corrupt count)`` under ``root``: a usable
    dump is one JSON object with a ``trigger``."""
    dumps, corrupt = [], 0
    for path in sorted(glob.glob(os.path.join(root, "**", "flight-*.json"),
                                 recursive=True)):
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or "trigger" not in doc:
                raise ValueError("not a flight dump")
        except (OSError, ValueError):
            corrupt += 1
            continue
        doc["_path"] = path
        dumps.append(doc)
    dumps.sort(key=lambda d: d.get("ts") or 0.0)
    return dumps, corrupt


def load_spool_records(root):
    """Every whole telemetry record under ``root``, by time (each
    directory read by ``telemetry.read_spool``)."""
    dirs = {os.path.dirname(p) for p in glob.glob(
        os.path.join(root, "**", "*.jsonl"), recursive=True)}
    records = []
    for d in sorted(dirs):
        for _name, text in telemetry.read_spool(d):
            for line in text.splitlines():
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    records.sort(key=lambda r: r.get("ts") or 0.0)
    return records


def _fmt_ts(ts):
    return (time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts))
            + ("%.3fZ" % (ts % 1))[1:])


def _fmt_rec(rec, t0):
    dur = rec.get("dur_ms")
    dur_s = f" ({dur:.1f}ms)" if isinstance(dur, (int, float)) else ""
    attrs = rec.get("attrs") or {}
    keys = ("trace_id", "sid", "error", "reason", "replica", "queue_ms")
    hint = " ".join(f"{k}={attrs[k]}" for k in keys if k in attrs)
    return (f"  {(rec.get('ts') or 0.0) - t0:+8.2f}s "
            f"{rec.get('kind', '?'):<5} {rec.get('name', '?')}{dur_s}"
            + (f"  [{hint}]" if hint else ""))


def render_report(dump, records, window, out):
    """One dump's section of the report, onto ``out``."""
    t0 = dump.get("ts") or 0.0
    victim = dump.get("node") or "<unknown>"
    by = dump.get("recorded_by") or {}
    print(f"POSTMORTEM  trigger={dump['trigger']}  victim={victim}  "
          f"reason={dump.get('reason')}", file=out)
    print(f"  at {_fmt_ts(t0)}  (observed by {by.get('node_id')}/"
          f"{by.get('role')}, dump "
          f"{os.path.basename(dump.get('_path', '?'))})", file=out)
    inflight = dump.get("inflight") or []
    print(f"\n  In flight at the event ({len(inflight)}):", file=out)
    for item in inflight or [{"(none)": ""}]:
        print("    " + " ".join(f"{k}={v}" for k, v in item.items()),
              file=out)
    nodes = {}
    for r in records:
        if t0 - window <= (r.get("ts") or 0.0) <= t0 + 1.0:
            nodes.setdefault(r.get("node_id", "?"), []).append(r)
    print(f"\n  Last {window:.0f}s before the event, per node:", file=out)
    for nid in sorted(nodes):
        last = nodes[nid][-1]
        mark = "  <- victim" if nid == victim else ""
        print(f"    {nid:<16} {len(nodes[nid]):>5} records   last: "
              f"{last.get('name', '?')} "
              f"({(last.get('ts') or 0) - t0:+.2f}s){mark}", file=out)
    if not nodes:
        print("    (no spool records in the window)", file=out)
    victim_recs = (nodes.get(victim)
                   or [r for r in dump.get("records") or []
                       if r.get("node_id") == victim])[-10:]
    print(f"\n  {victim}'s last records:", file=out)
    for r in victim_recs:
        print(_fmt_rec(r, t0), file=out)
    if not victim_recs:
        print("    (none found — the ring died with the process; see "
              "the observer's dump records above)", file=out)
    print("", file=out)


def build_parser():
    p = argparse.ArgumentParser(
        prog="tfos-postmortem-torch",
        description="Assemble flight-recorder dumps into a "
                    "who-was-doing-what report")
    p.add_argument("--dir", required=True,
                   help="telemetry tree holding flight-*.json dumps and "
                        "*.jsonl spools (TFOS_TELEMETRY_DIR)")
    p.add_argument("--window", type=float, default=None,
                   help="trailing seconds of context a report (default: "
                        "the dump's own window)")
    p.add_argument("--all", action="store_true",
                   help="render every dump, not just the newest")
    return p


def main(argv=None, out=None):
    out = out or sys.stdout
    args = build_parser().parse_args(argv)
    dumps, corrupt = load_dumps(args.dir)
    if corrupt:
        print(f"tfos-postmortem-torch: skipped {corrupt} corrupt/"
              f"truncated dump(s)", file=out)
    if not dumps:
        print(f"tfos-postmortem-torch: no usable flight dumps under "
              f"{args.dir}", file=out)
        return 2
    records = load_spool_records(args.dir)
    for dump in (dumps if args.all else dumps[-1:]):
        window = (args.window if args.window is not None
                  else float(dump.get("window_s") or 30.0))
        render_report(dump, records, window, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
