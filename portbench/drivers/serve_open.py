"""The general driver of served cells: an open loop of requests against
the program's decode engine in this process.

Entry: ``serving.decode.scheduler.DecodeEngine`` over the paged KV cache
(``DecodeSpec(paged=True, prefix_sharing=...)``), CUDA graphs on
(``jit=None``), greedy decoding.  The weights are drawn on the card from
the seed by the plain reference's initialiser, products' weights cast to
the compute dtype they are served in, norm scales float32.

The mix fixes ``requests`` (prompt length, output length) pairs, drawn
once from ``sizes_seed`` (log-normal around the mix's medians, clipped),
and their Poisson arrival times at ``rate`` requests a second, drawn
once from ``arrivals_seed`` (``frozen.arrivals``).  The run's seed
shuffles the sizes over those times and draws every prompt's tokens
uniformly from the vocabulary (``frozen.draw_tokens``): every seed
offers the same sizes at the same times, in another order.  A request
is sent when it is due, whatever is outstanding, and timed from then.

Set-up warms every prefill signature the load reaches (rows up to
``warm_rows`` by each sequence bucket the prompts fall in) and the
decode step, then offers ``warm_s`` of load.  The window follows for
``--seconds``.  Then no more is sent, the requests out finish (waited
for ``drain_s`` at most), the engine stops, and a sample of
finished requests is held against the plain reference's full forward.
"""

from __future__ import annotations

import json
import math
import random
import sys
import threading
import time

from portbench import check, flops, frozen
from portbench.reference import transformer as ref


def request_sizes(tr):
    rng = frozen.stdlib_rng(tr["sizes_seed"])
    out = []
    for _ in range(tr["requests"]):
        p = rng.lognormvariate(math.log(tr["prompt_median"]),
                               tr["prompt_sigma"])
        o = rng.lognormvariate(math.log(tr["output_median"]),
                               tr["output_sigma"])
        out.append((int(min(max(p, tr["prompt_min"]), tr["prompt_max"])),
                    int(min(max(o, tr["output_min"]), tr["output_max"]))))
    return out


def port_config(cfg):
    from tensorflowonspark_tpu_torch.models import transformer as T

    return T.Config(vocab_size=cfg["vocab_size"], dim=cfg["hidden_size"],
                    n_layers=cfg["num_hidden_layers"],
                    n_heads=cfg["num_attention_heads"],
                    max_seq=cfg["max_position_embeddings"],
                    mlp_ratio=cfg["intermediate_size"] // cfg["hidden_size"],
                    rope_base=cfg["rotary_emb_base"], dtype=cfg["dtype"])


def params_tree(cfg, seed, device):
    """The port's params tree of the seeded weights, in the types they
    are served in: products' weights, the embedding and the head in the
    compute dtype, norm scales float32."""
    import torch

    dt = getattr(torch, cfg["dtype"])
    leaves = {}
    for name, t in ref.init_leaves(cfg, seed, device):
        leaves[name] = t if name.startswith("ln") else t.to(dt)
        del t
    return {"embed": leaves.pop("embed"), "ln_f": leaves.pop("ln_f"),
            "head": leaves.pop("head"), "layers": leaves}


class Sessions:
    """The emit wire: each session's due time, token times and end."""

    def __init__(self):
        self.lock = threading.Lock()
        self.s = {}

    def open(self, sid, prompt, out_len, due):
        ev = threading.Event()
        with self.lock:
            self.s[sid] = {"prompt": prompt, "want": out_len,
                           "t_submit": due, "times": [], "tokens": [],
                           "error": None, "done": ev}
        return ev

    def emit(self, kind, sid, *payload):
        now = time.perf_counter()
        with self.lock:
            st = self.s.get(sid)
        if st is None:
            return
        if kind == "token":
            st["times"].append(now)
            st["tokens"].append(int(payload[1]))
        elif kind in ("done", "error"):
            if kind == "error":
                st["error"] = str(payload[0])
            st["end"] = now
            st["done"].set()


def trace_all_threads():
    """The profiler's option to record the engine thread's host
    operations too, where this torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


class Served:
    """The program's engine on the seeded weights, warmed for a mix."""

    def __init__(self, ctx):
        import torch

        from tensorflowonspark_tpu_torch.serving.decode.scheduler import (
            DecodeEngine, DecodeSpec)

        tr, cfg = ctx.traffic, ctx.config
        self.ctx, self.tr, self.cfg = ctx, tr, cfg
        self.dev = torch.device(ctx.device)
        pcfg = port_config(cfg)
        self.max_seq = pcfg.max_seq
        # the pool holds the slots' whole contexts and no more
        spec = DecodeSpec(pcfg, slots=tr["slots"], paged=True,
                          block_size=tr["block_size"],
                          num_blocks=1 + tr["slots"] * -(
                              -self.max_seq // tr["block_size"]),
                          prefix_sharing=tr["prefix_sharing"],
                          max_tokens=tr["output_max"])
        self.sessions = Sessions()
        self.engine = DecodeEngine(
            params_tree(cfg, ctx.seed, self.dev), spec, self.sessions.emit,
            device=self.dev, jit=False if ctx.device == "cpu" else None)
        self.engine.start(timeout=600)

    def warm(self, sizes):
        """One prefill of each (rows, sequence bucket) the load reaches,
        each a burst of distinct prompts that one admission takes."""
        tr, vocab = self.tr, self.cfg["vocab_size"]
        rng = frozen.stdlib_rng(self.ctx.seed + 1)
        buckets = sorted({min(1 << max(0, (p - 1).bit_length()),
                              self.max_seq) for p, _ in sizes})
        rows = 1
        while rows <= min(tr["warm_rows"], tr["slots"]):
            for t in buckets:
                n = min(t, self.max_seq - 2)
                prompts = [frozen.draw_tokens(rng, n, vocab)
                           for _ in range(rows)]
                old = sys.getswitchinterval()
                sys.setswitchinterval(1.0)  # the engine sees all at once
                try:
                    for i, prompt in enumerate(prompts):
                        sid = f"warm-{rows}-{t}-{i}"
                        self.sessions.open(sid, prompt, 2,
                                           time.perf_counter())
                        self.engine.submit(sid, prompt, max_tokens=2)
                finally:
                    sys.setswitchinterval(old)
                if self.drain():
                    raise RuntimeError("a warm-up request never ended")
            rows *= 2

    def offer(self, requests, t0, stop_at):
        """Send each ``(sid, prompt, out_len, offset)`` at ``t0 +
        offset`` until ``stop_at``; returns how late the sender ran at
        most (seconds)."""
        late = 0.0
        for sid, prompt, out_len, at in requests:
            due = t0 + at
            if due > stop_at:
                break
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            late = max(late, time.perf_counter() - due)
            self.sessions.open(sid, prompt, out_len, due)
            self.engine.submit(sid, prompt, max_tokens=out_len)
        return late

    def drain(self):
        """Wait, ``drain_s`` at most, for every request out to end;
        returns how many did not."""
        with self.sessions.lock:
            evs = [s["done"] for s in self.sessions.s.values()]
        deadline = time.perf_counter() + self.tr["drain_s"]
        return sum(not ev.wait(max(0.0, deadline - time.perf_counter()))
                   for ev in evs)

    def stop(self):
        self.engine.stop(timeout=60)
        self.engine = None


def requests(ctx, rate, horizon):
    """The requests due within ``horizon`` seconds at ``rate``: the mix's
    sizes shuffled by the seed at the mix's arrival times."""
    tr, cfg = ctx.traffic, ctx.config
    sizes = request_sizes(tr)
    random.Random(ctx.seed).shuffle(sizes)
    due = frozen.arrivals(frozen.stdlib_rng(tr["arrivals_seed"]),
                          len(sizes), rate)
    out = []
    for i, ((p, o), at) in enumerate(zip(sizes, due)):
        if at > horizon:
            break
        prompt = frozen.draw_tokens(
            frozen.stdlib_rng(ctx.seed * 1_000_003 + i), p,
            cfg["vocab_size"])
        out.append((f"r{i}", prompt, min(o, cfg["max_position_embeddings"]
                                         - p), at))
    return sizes, out


def run(ctx):
    import torch

    tr, cfg = ctx.traffic, ctx.config
    cuda = ctx.device == "cuda"
    horizon = tr["warm_s"] + ctx.seconds
    sizes, reqs_due = requests(ctx, tr["rate"], horizon)
    if not reqs_due or reqs_due[-1][3] < horizon - 5.0 / tr["rate"]:
        raise RuntimeError("the mix holds too few requests for the window")
    served = Served(ctx)
    prof = trace_stop = None
    try:
        served.warm(sizes)
        graphs0 = served.engine.stats()
        if cuda:
            torch.cuda.reset_peak_memory_stats(served.dev)
        t0 = time.perf_counter()
        t_window = time.time() + tr["warm_s"]
        w0, w1 = t0 + tr["warm_s"], t0 + horizon
        late = []
        sender = threading.Thread(target=lambda: late.append(served.offer(
            reqs_due, t0, w1)), daemon=True)
        sender.start()
        if ctx.trace:
            from torch.profiler import ProfilerActivity, profile

            time.sleep(max(0.0, w0 + 1.0 - time.perf_counter()))
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts, **trace_all_threads())
            prof.start()
            time.sleep(tr["trace_seconds"])
            if cuda:
                torch.cuda.synchronize()
            prof.stop()
            trace_stop = time.perf_counter()
        sender.join(horizon + 60)
        graphs1 = served.engine.stats()
        unended = served.drain()
        memory_peak = (torch.cuda.max_memory_allocated(served.dev)
                       if cuda else None)
    finally:
        served.stop()
    trace = None
    if prof is not None:
        from portbench import trace as tracemod

        trace = tracemod.compact(prof)
    if cuda:
        torch.cuda.empty_cache()

    with served.sessions.lock:
        reqs = [dict(s, sid=k) for k, s in served.sessions.s.items()
                if k.startswith("r")]
    t = tally(reqs, w0, w1, cfg)
    if trace_stop is not None and trace_stop < w1:
        # per-layer readings over the window after the capture stopped
        t = dict(tally(reqs, trace_stop, w1, cfg), window_s=w1 - trace_stop)

    # the check: a sample of the window's finished requests, with the
    # longest
    done = [s for s in reqs if s["error"] is None and "end" in s
            and len(s["tokens"]) == s["want"] and w0 <= s["end"] <= w1]
    numbers = {"served_gap": float("inf"), "unended": float(unended),
               "failed": float(sum(s["error"] is not None for s in reqs))}
    sample = []
    if done:
        done.sort(key=lambda s: (len(s["tokens"]), s["sid"]))
        rest = done[:-1]
        random.Random(ctx.seed + 7).shuffle(rest)
        sample, budget = [done[-1]], tr["check_tokens"] - len(
            done[-1]["tokens"])
        for s in rest:
            if budget <= 0:
                break
            sample.append(s)
            budget -= len(s["tokens"])
        numbers["served_gap"] = served_gap(cfg, ctx.seed, served.dev, sample)
    controls = None
    if ctx.controls and sample:
        controls = {"control_float8": {"served_gap": served_gap(
            cfg, ctx.seed, served.dev, sample, control="float8")}}
        ctx.log(f"controls {json.dumps(controls)}")
    checks = check.held(numbers, ctx.cell["limits"])
    ctx.log(f"numbers {json.dumps(numbers)}; check sample {len(sample)} "
            f"requests, {sum(len(s['tokens']) for s in sample)} served "
            f"tokens; sender late by {late[0] if late else None} s; graphs "
            f"{graphs0.get('graphs')} -> {graphs1.get('graphs')} over the "
            f"load; {json.dumps(graphs1)}")
    return {
        "kind": "serve", "cell": ctx.name, "config": cfg, "traffic": tr,
        "setup_s": t_window - ctx.t0,
        "window_s": t.pop("window_s", w1 - w0),
        "serve": dict(t, captures=graphs1.get("graphs", 0)
                      - graphs0.get("graphs", 0)),
        "trace": trace, "attempted": t["attempted"], "failed": t["failed"],
        "checks": checks, "controls": controls, "numbers": numbers,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": ctx.cell["chips"],
                   "memory_peak_bytes": memory_peak}}


def tally(reqs, w0, w1, cfg):
    """The window ``[w0, w1]``'s numbers from every request's due time,
    token arrival times and error: the first tokens' times from when
    each was due (a request due in the window that failed counts as
    infinitely late), every gap between a session's consecutive tokens
    that ends in the window, the tokens that arrived in it, their model
    FLOPs (a prompt's prefill counts where its first token arrives), and
    the requests due in it and those of them that failed."""
    ttft, gaps, tokens, fl, attempted, failed = [], [], 0, 0.0, 0, 0
    for s in reqs:
        times, sent = s["times"], w0 <= s["t_submit"] <= w1
        attempted += sent
        if s["error"] is not None:
            failed += sent
            if sent:
                ttft.append(float("inf"))
        elif times and w0 <= times[0] <= w1:
            ttft.append(1e3 * (times[0] - s["t_submit"]))
            fl += flops.lm_forward_flops(cfg, len(s["prompt"]))
        for j in range(1, len(times)):
            if w0 <= times[j] <= w1:
                gaps.append(1e3 * (times[j] - times[j - 1]))
                fl += flops.lm_decode_flops(cfg, len(s["prompt"]) + j)
        tokens += sum(1 for x in times if w0 <= x <= w1)
    return {"ttft_ms": ttft, "itl_ms": gaps, "tokens": tokens, "flops": fl,
            "attempted": attempted, "failed": failed}


def served_gap(cfg, seed, device, sample, control=None):
    """The widest gap by which a served token's reference logit lies
    below the reference's best at its position.  With ``control`` (a
    lower precision), the token that precision puts first at each
    position stands in for the served one."""
    import torch

    from portbench.reference import no_tf32

    no_tf32()
    params = dict(ref.init_leaves(cfg, seed, device))
    worst = 0.0
    with torch.no_grad():
        for s in sample:
            seq = s["prompt"] + s["tokens"][:-1]
            toks = torch.tensor([seq], dtype=torch.long, device=device)
            pos = torch.arange(len(s["prompt"]) - 1, len(seq),
                               device=device)
            rows = ref.logits(params, toks, cfg)[0][pos]
            if control is None:
                served = torch.tensor(s["tokens"], dtype=torch.long,
                                      device=device)
            else:
                served = ref.logits(params, toks, cfg, control)[0][
                    pos].argmax(dim=-1)
            gap = rows.max(dim=-1).values - rows.gather(
                1, served[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            del rows
    del params
    return worst
