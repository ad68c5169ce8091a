#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper,
``sm_90a``).  It builds the port's kernels from the checkout's sources
into ``build/torch_kernels/`` and drives the port's main path:

0. preflight: a CUDA device must be present (else exit 2 at once); the
   card's name and power limit from ``nvidia-smi``; TF32 off for float32
   matmuls and convolutions, bf16 matmuls accumulate in float32;
1. build every kernel (one ``nvcc`` per source, started together);
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes, with times beside its bound and a library call;
3. serving at full width (the repo's on-chip transformer config, bf16):
   a paged, prefix-sharing ``DecodeEngine`` answers 16 sessions; every
   token index streams once and in order, the prefix trie is hit, the
   cache ends empty with no leaked block, and the flash kernel ran on
   every layer of every plain prefill;
4. token-exactness at full width in float32: ``DecodeEngine`` greedy
   tokens equal the full-recompute ``greedy_decode_reference`` with
   ``mha_reference`` attention, which never touches a kernel.

Any failure raises, so the exit code is non-zero and the last line is
not printed.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels' results.  Imports only torch,
numpy and the port.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from tensorflowonspark_tpu_torch.models import transformer as T
from tensorflowonspark_tpu_torch.ops import _build, attention
from tensorflowonspark_tpu_torch.serving.decode import (
    DecodeEngine,
    DecodeSpec,
)

# H100 SXM data-sheet peaks (dense), at the full 700 W power limit
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# bench.py's on-chip transformer: the only full-width config the repo runs
FULL = dict(vocab_size=16384, dim=1024, n_layers=8, n_heads=8, max_seq=2048)

# (B, S, H, D, causal, dtype, out tolerance); the first is the main path's
# full prompt bucket, the one the kernels line reports
FLASH_CASES = [
    (8, 2048, 8, 128, True, torch.bfloat16, 3e-2),
    (2, 96, 8, 128, False, torch.float32, 2e-5),   # tail masking
    (1, 1, 8, 128, True, torch.bfloat16, 3e-2),    # a one-token prompt
    (3, 300, 4, 64, True, torch.float32, 2e-5),    # head_dim 64
]
LSE_TOL = 1e-4


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_bound_ms(b, sq, skv, h, d, causal, dtype):
    """Least time for the card: the larger of the flops this input needs
    (2 matmuls of 2*D flops per visible (q, kv) pair) over the peak for
    the dtype, and the bytes (q, k, v read once, out and lse written
    once) over the memory rate."""
    if causal:
        pairs = sum(min(i + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    flops = 4.0 * b * h * d * pairs
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * b * h * d * (2 * sq + 2 * skv) + 4 * b * h * sq
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_flash(dev):
    """Kernel against the plain version; returns the main case's row."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    for b, s, h, d, causal, dtype, tol in FLASH_CASES:
        # q, k, v as strided views of a fused projection, as prefill has them
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev,
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scale = 1.0 / d ** 0.5
        out, lse = attention._flash_forward(q, k, v, causal=causal,
                                            scale=scale)
        ref, ref_lse = attention.flash_attention_plain(q, k, v, causal=causal,
                                                       scale=scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if not (err <= tol and lse_err <= LSE_TOL):
            raise AssertionError(
                f"flash_fwd disagrees with its plain version at "
                f"{(b, s, h, d, causal, dtype)}: out err {err} (tol {tol}), "
                f"lse err {lse_err} (tol {LSE_TOL})")
        reps = 20 if s >= 1024 else 50
        ms = time_ms(lambda: attention._flash_forward(
            q, k, v, causal=causal, scale=scale), reps)
        plain_ms = time_ms(lambda: attention.flash_attention_plain(
            q, k, v, causal=causal, scale=scale), reps)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale), reps)
        bound, bound_by = flash_bound_ms(b, s, s, h, d, causal, dtype)
        row = dict(shape=[b, s, h, d], causal=causal,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   lse_err=lse_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=bound_by, library_ms=library_ms)
        print("flash_fwd case " + json.dumps(row), flush=True)
        rows.append(row)
    return rows[0]


def run_engine(params, spec, jobs, dev, timeout):
    """Submit ``jobs`` = [(sid, prompt)] to a fresh engine on the card and
    wait for all; any error emission or init error raises.  Returns
    (done {sid: tokens}, streamed {sid: [(index, token)]}, first-token
    times {sid: s}, wall seconds, stats, engine)."""
    lock = threading.Lock()
    done, errors = {}, {}
    streamed = {sid: [] for sid, _ in jobs}
    first = {}
    t_submit = {}

    def emit(kind, sid, *rest):
        now = time.perf_counter()
        with lock:
            if kind == "token":
                streamed[sid].append(tuple(int(x) for x in rest))
                if rest[0] == 0:
                    first[sid] = now - t_submit[sid]
            elif kind == "done":
                done[sid] = [int(t) for t in rest[0]]
            else:
                errors[sid] = rest[0]

    eng = DecodeEngine(params, spec, emit, device=dev)
    eng.start(timeout=600)
    try:
        t0 = time.perf_counter()
        for sid, prompt in jobs:
            with lock:
                t_submit[sid] = time.perf_counter()
            eng.submit(sid, prompt)
        deadline = time.time() + timeout
        while time.time() < deadline:
            with lock:
                if errors or len(done) == len(jobs):
                    break
            time.sleep(0.005)
        wall = time.perf_counter() - t0
        stats = eng.stats()
    finally:
        eng.stop()
    if errors:
        raise AssertionError(f"engine emitted errors: {errors}")
    if len(done) != len(jobs):
        raise AssertionError(f"only {len(done)}/{len(jobs)} sessions done "
                             f"within {timeout}s")
    return done, streamed, first, wall, stats, eng


def device_breakdown(prof, wall_s):
    """Device time of a profiled run: busy time (union of kernel and copy
    intervals), the idle share of ``wall_s``, and time by kernel group."""
    spans, groups, names = [], collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        name = e.name
        low = name.lower()
        group = ("flash_fwd" if "flash_fwd" in low else
                 "memcpy" if "memcpy" in low else
                 "matmul" if any(w in low for w in ("gemm", "nvjet",
                                                    "cutlass", "cublas"))
                 else "softmax" if "softmax" in low else
                 "index/gather/scatter" if any(
                     w in low for w in ("index", "gather", "scatter"))
                 else "other")
        groups[group] += (t1 - t0) / 1e3
        names[name[:90]] += (t1 - t0) / 1e3
    busy, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    busy_ms = busy / 1e3
    return dict(wall_ms=1e3 * wall_s, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / (1e3 * wall_s),
                device_events=len(spans),
                groups_ms=dict(groups.most_common()),
                top_kernels_ms=names.most_common(8))


def phase_serving(dev, gpu):
    cfg = T.Config(**FULL, dtype="bfloat16", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in params.values() if torch.is_tensor(p))
    n_params += sum(p.numel() for p in params["layers"].values())
    spec = DecodeSpec(cfg, slots=8, paged=True, block_size=16,
                      prefix_sharing=True, max_tokens=32)
    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab_size, size=512).tolist()
    jobs = []
    for i in range(16):
        n = int(rng.integers(64, 1536 + 1))
        if i % 2 == 0:   # 8 sessions share a 512-token system prompt
            n = max(n, 512 + 16)
            prompt = system + rng.integers(1, cfg.vocab_size,
                                           size=n - 512).tolist()
        else:
            prompt = rng.integers(1, cfg.vocab_size, size=n).tolist()
        jobs.append((f"s{i:02d}", prompt))
    attention.launches = 0
    done, streamed, first, wall, stats, eng = run_engine(
        params, spec, jobs, dev, timeout=600)
    launches = attention.launches
    for sid, prompt in jobs:
        toks = done[sid]
        if [i for i, _ in streamed[sid]] != list(range(32)):
            raise AssertionError(f"{sid}: streamed indices "
                                 f"{[i for i, _ in streamed[sid]]}")
        if [t for _, t in streamed[sid]] != toks or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{sid}: bad tokens {toks}")
    cache = eng._cache
    if stats["prefix_hits"] < 1:
        raise AssertionError(f"no prefix hit: {stats}")
    if cache.occupancy != 0 or cache.leaked_blocks() != []:
        raise AssertionError(f"cache not drained: occupancy "
                             f"{cache.occupancy}, leaked "
                             f"{cache.leaked_blocks()}")
    plain_prefills = stats["prefills"] - stats["extends"]
    if launches < cfg.n_layers * plain_prefills or launches == 0:
        raise AssertionError(f"flash kernel launched {launches} times for "
                             f"{plain_prefills} plain prefills x "
                             f"{cfg.n_layers} layers")
    ttft = sorted(first.values())
    summary = dict(
        params=n_params, sessions=len(jobs), tokens=32 * len(jobs),
        ttft_p50_ms=1e3 * float(np.percentile(ttft, 50)),
        ttft_p99_ms=1e3 * float(np.percentile(ttft, 99)),
        tokens_per_s=32 * len(jobs) / wall, wall_s=wall,
        prefills=stats["prefills"], extends=stats["extends"],
        prefix_hits=stats["prefix_hits"],
        prefix_tokens_saved=stats["prefix_tokens_saved"],
        iterations=stats["iterations"], flash_launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, gpu=gpu)
    print("serving " + json.dumps(summary), flush=True)
    # the same traffic once more under the profiler: where the device time
    # goes and how much of the wall the device sits idle (the profiler's
    # own overhead lengthens this wall)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, _, _, pwall, _, _ = run_engine(params, spec, jobs, dev,
                                          timeout=600)
    print("serving profile " + json.dumps(device_breakdown(prof, pwall)),
          flush=True)
    del params, eng, cache
    torch.cuda.empty_cache()
    return launches


def phase_exact(dev):
    cfg = T.Config(**FULL, dtype="float32", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    spec = DecodeSpec(cfg, slots=8, paged=True, block_size=16,
                      prefix_sharing=True, max_tokens=16)
    rng = np.random.default_rng(1)
    jobs = [(f"x{n}", rng.integers(1, cfg.vocab_size, size=n).tolist())
            for n in (40, 300, 1100)]
    before = attention.launches
    done, _, _, _, _, _ = run_engine(params, spec, jobs, dev, timeout=600)
    if attention.launches == before:
        raise AssertionError("float32 engine run never launched the kernel")
    ref_attn = lambda q, k, v: attention.mha_reference(q, k, v, causal=True)
    for sid, prompt in jobs:
        ref = T.greedy_decode_reference(params, prompt, cfg, max_tokens=16,
                                        attn_fn=ref_attn)
        if done[sid] != ref:
            raise AssertionError(f"{sid}: engine {done[sid]} != "
                                 f"reference {ref}")
    print(f"exact float32: {len(jobs)} prompts x 16 greedy tokens equal the "
          "full-recompute reference", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    # float32 stays float32: no TF32 in matmuls or convolutions, and bf16
    # matmuls accumulate in float32 as the reference's do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {json.dumps(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    main_case = phase_flash(dev)
    launches = phase_serving(dev, gpu)
    phase_exact(dev)

    kernels = [dict(
        name="flash_fwd", route="cuda",
        source="tensorflowonspark_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="tensorflowonspark_tpu/ops/attention.py:88",
        launches=launches, max_abs_err=main_case["max_abs_err"],
        ms=main_case["ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"])]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
