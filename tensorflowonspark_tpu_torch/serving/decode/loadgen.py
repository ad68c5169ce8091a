"""Open-loop Poisson-arrival load generator for serving SLOs.

An own copy of ``tensorflowonspark_tpu/serving/decode/loadgen.py``,
verbatim below this docstring: ``shared_prefix_prompts``,
``session_route_ids`` and ``run_open_loop``.  Arrivals are scheduled
from a seeded exponential inter-arrival process and fired on schedule
regardless of how many requests are still outstanding, so p99 latency
and shed counts reflect the arrival process an SLO is written against
(a closed loop self-throttles exactly when the server slows down).

Pure stdlib.
"""

from __future__ import annotations

import random
import threading
import time


def _pct(sorted_vals, q):
    """Nearest-rank percentile (server.SLOStats convention)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def shared_prefix_prompts(n, *, vocab_size, prefix_pool=4, prefix_len=64,
                          prefix_frac=0.6, tail_lo=9, tail_hi=16, seed=0):
    """Decode-lane traffic with a shared-system-prompt population.

    Returns ``(prompts, pool)``: ``prompts`` is ``n`` token-id lists of
    which a seeded ``prefix_frac`` fraction start with one of
    ``prefix_pool`` fixed ``prefix_len``-token "system prompts"
    (followed by a unique random tail), the rest are fully random —
    the fan-in shape the prefix trie exists for.  ``pool`` is the list
    of system prompts, so callers can warm the trie or compute
    expected savings.

    The prefix length is FIXED and the tail band ``[tail_lo,
    tail_hi]`` narrow, so shared-prefix requests fall into one
    (tail-bucket, prefix-block-bucket) compile group — the bench A/B
    measures paging, not compile-cache asymmetry.  Tokens stay in
    ``[1, vocab_size)``: 0 is left out so prompts never collide with
    inert padding.  Pure stdlib.
    """
    rng = random.Random(seed)
    draw = lambda ln: [rng.randrange(1, int(vocab_size)) for _ in range(ln)]
    pool = [draw(int(prefix_len)) for _ in range(int(prefix_pool))]
    prompts = []
    for _ in range(int(n)):
        tail = draw(rng.randint(int(tail_lo), int(tail_hi)))
        if rng.random() < float(prefix_frac):
            prompts.append(rng.choice(pool) + tail)
        else:
            prompts.append(draw(int(prefix_len)) + tail)
    return prompts, pool


def session_route_ids(n, sessions, seed=0):
    """``n`` request route-ids drawn from ``sessions`` stable sessions.

    Returns a list of ``n`` strings ``"s<k>"`` assigned by a seeded rng,
    modelling returning clients: every request carrying the same id is
    the *same* conversation, so the fabric's affinity router should land
    it on the replica whose paged KV cache already holds its prefix.
    Pure stdlib; pair with ``run_open_loop(..., route_fn=ids.__getitem__)``.
    """
    rng = random.Random(seed)
    return [f"s{rng.randrange(int(sessions))}" for _ in range(int(n))]


def run_open_loop(request_fn, *, rate_rps, n_requests, seed=0,
                  shed_exc=None, route_fn=None):
    """Fire ``n_requests`` calls of ``request_fn(i)`` at Poisson arrivals
    of ``rate_rps`` and aggregate SLO stats.

    ``request_fn`` runs on a per-arrival thread.  It may return None (a
    plain request — only wall latency is recorded) or a dict with any of
    ``ttft_ms`` (float), ``token_ms`` (list of per-token gap floats),
    ``tokens`` (int count), ``affinity`` (``"hit"``/``"miss"``/
    ``"fallback"`` as stamped by the fabric router).  Raising
    ``shed_exc`` counts as a shed; any other exception counts as an
    error.  Neither stops the run — an open loop keeps offering load.

    ``route_fn`` (optional) maps the request index to a stable session
    route-id (see :func:`session_route_ids`); when given, requests are
    fired as ``request_fn(i, route_fn(i))`` so the caller can thread the
    id to ``Server.generate(route_id=...)``.

    Returns one stats dict: request/shed/error counts, offered vs
    completed rate, latency p50/p99, TTFT p50/p99 and pooled per-token
    p50/p99 (when any request reported them), aggregate tokens/s, and —
    when any request reported an affinity outcome — affinity
    hit/miss/fallback counts plus ``affinity_hit_rate``.
    """
    rng = random.Random(seed)
    arrivals, t = [], 0.0
    for _ in range(int(n_requests)):
        arrivals.append(t)
        t += rng.expovariate(float(rate_rps))

    lock = threading.Lock()
    latency_ms, ttft_ms, token_ms = [], [], []
    counts = {"completed": 0, "shed": 0, "errors": 0, "tokens": 0}
    affinity = {"hit": 0, "miss": 0, "fallback": 0}

    def _one(i):
        t0 = time.perf_counter()
        try:
            if route_fn is not None:
                out = request_fn(i, route_fn(i))
            else:
                out = request_fn(i)
        except Exception as e:  # noqa: BLE001 - classified, never raised
            key = ("shed" if shed_exc is not None
                   and isinstance(e, shed_exc) else "errors")
            with lock:
                counts[key] += 1
            return
        dur = (time.perf_counter() - t0) * 1e3
        with lock:
            counts["completed"] += 1
            latency_ms.append(dur)
            if isinstance(out, dict):
                if out.get("ttft_ms") is not None:
                    ttft_ms.append(float(out["ttft_ms"]))
                token_ms.extend(float(g) for g in out.get("token_ms") or ())
                counts["tokens"] += int(out.get("tokens") or 0)
                if out.get("affinity") in affinity:
                    affinity[out["affinity"]] += 1

    threads = []
    start = time.perf_counter()
    for i, at in enumerate(arrivals):
        delay = start + at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=_one, args=(i,),
                              name=f"tfos-loadgen-{i}", daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    wall = max(time.perf_counter() - start, 1e-9)

    latency_ms.sort()
    ttft_ms.sort()
    token_ms.sort()
    out = {
        "requests": int(n_requests),
        "completed": counts["completed"],
        "shed": counts["shed"],
        "errors": counts["errors"],
        "offered_rps": round(rate_rps, 3),
        "completed_rps": round(counts["completed"] / wall, 3),
        "duration_s": round(wall, 3),
        "latency_p50_ms": round(_pct(latency_ms, 0.50), 3),
        "latency_p99_ms": round(_pct(latency_ms, 0.99), 3),
    }
    if ttft_ms:
        out["ttft_p50_ms"] = round(_pct(ttft_ms, 0.50), 3)
        out["ttft_p99_ms"] = round(_pct(ttft_ms, 0.99), 3)
    if token_ms:
        out["tok_p50_ms"] = round(_pct(token_ms, 0.50), 3)
        out["tok_p99_ms"] = round(_pct(token_ms, 0.99), 3)
    if counts["tokens"]:
        out["tokens"] = counts["tokens"]
        out["tokens_per_sec"] = round(counts["tokens"] / wall, 2)
    routed = sum(affinity.values())
    if routed:
        out["affinity_hits"] = affinity["hit"]
        out["affinity_misses"] = affinity["miss"]
        out["affinity_fallbacks"] = affinity["fallback"]
        out["affinity_hit_rate"] = round(affinity["hit"] / routed, 4)
    return out
