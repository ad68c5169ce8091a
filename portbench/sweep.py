"""The load a served cell's engine sustains: one engine on the cell's
configuration, warmed once, offered the cell's mix at each rate in
turn::

    python3 portbench/sweep.py --workload <served cell> \\
        --rates 2,4,6,8 --seconds 30

For each rate it prints the tokens delivered a second in the window,
the time to first token (median, 95th percentile), the requests still
queued or in flight when the window closed, and how late the sender
ran.  A rate is sustained where those stay bounded from one rate to the
next; the cell's ``rate`` sits at about four fifths of the highest."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench import harness, readers
    from portbench.drivers import serve_open

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args()
    harness.setup_env()
    cell = harness.load_json("cells", a.workload)
    ctx = harness.Context(a.workload, cell,
                          harness.load_json("configs", cell["config"]),
                          harness.load_json("traffic", cell["traffic"]),
                          a.seed, a.seconds, False, "", time.time())
    served = serve_open.Served(ctx)
    try:
        sizes, _ = serve_open.requests(ctx, 1.0, 0)
        served.warm(sizes)
        for k, rate in enumerate(float(r) for r in a.rates.split(",")):
            horizon = ctx.traffic["warm_s"] + a.seconds
            _, reqs = serve_open.requests(ctx, rate, horizon)
            reqs = [(f"{k}-{sid}", *rest) for sid, *rest in reqs]
            t0 = time.perf_counter()
            w0, w1 = t0 + ctx.traffic["warm_s"], t0 + horizon
            late = served.offer(reqs, t0, w1)
            st = served.engine.stats()
            served.drain()
            with served.sessions.lock:
                mine = [s for sid, s in served.sessions.s.items()
                        if sid.startswith(f"{k}-")]
            t = serve_open.tally(mine, w0, w1, ctx.config)
            print(json.dumps({
                "rate": rate, "tokens_per_s": t["tokens"] / (w1 - w0),
                "ttft_p50_ms": readers._pct(t["ttft_ms"], 0.5),
                "ttft_p95_ms": readers._pct(t["ttft_ms"], 0.95),
                "itl_p95_ms": readers._pct(t["itl_ms"], 0.95),
                "due": t["attempted"], "failed": t["failed"],
                "queued_at_close": st["queued"],
                "active_at_close": st["active"], "sender_late_s": late,
                "graphs": st["graphs"]}), flush=True)
    finally:
        served.stop()
