"""Frozen copies of sound arithmetic the port's own scripts carry.

Each function is copied, not imported, so that a later change to the
program cannot move the yardstick.  The note above each names the file
and line it was copied from.  Only the dtype lookups changed: the
originals key their tables by ``torch`` dtypes, these by name.
"""

from __future__ import annotations

import random

# chip_smoke.py:631-633 (H100 SXM data sheet, dense, 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


# chip_smoke.py:976 visible_pairs
def visible_pairs(sq, skv, causal):
    """(q, kv) pairs the causal or full mask leaves visible, per head."""
    if causal:
        return sum(min(i + 1, skv) for i in range(sq))
    return sq * skv


# chip_smoke.py:990 bound_ms
def bound_ms(flops, nbytes, dtype):
    """Least time for the card: the larger of ``flops`` over the dense
    peak for the dtype and ``nbytes`` over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# chip_smoke.py:998 flash_bound_ms
def flash_bound_ms(b, sq, skv, h, d, causal, dtype):
    """Forward: 2 matmuls of 2*D flops per visible (q, kv) pair; q, k, v
    read once, out and lse written once."""
    esize = ELEMENT_SIZE[dtype]
    nbytes = esize * b * h * d * (2 * sq + 2 * skv) + 4 * b * h * sq
    return bound_ms(4.0 * b * h * d * visible_pairs(sq, skv, causal), nbytes,
                    dtype)


# chip_smoke.py:1007 flash_bwd_bound_ms
def flash_bwd_bound_ms(kernel, b, sq, skv, h, d, causal, dtype):
    """Backward kernels.  dq: s, dp and dq, 3 products of 2*D flops per
    visible pair; dk/dv: s, dp, dv and dk, 4 products; the pair as one
    backward ("pair"): s, dp, dq, dk and dv, 5 products.  Bytes: q, k,
    v, g, lse and delta read once, the kernel's gradients written once."""
    esize = ELEMENT_SIZE[dtype]
    products, n_out = {"flash_dq": (3, sq), "flash_dkv": (4, 2 * skv),
                       "pair": (5, sq + 2 * skv)}[kernel]
    flops = 2.0 * products * b * h * d * visible_pairs(sq, skv, causal)
    nbytes = (esize * b * h * d * (2 * sq + 2 * skv + n_out)
              + 8 * b * h * sq)
    return bound_ms(flops, nbytes, dtype)


# chip_smoke.py:1815 _union
def _union(spans):
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy


# chip_smoke.py:1828 device_breakdown, reading (name, start, end)
# intervals in microseconds instead of a profiler object's events
def device_breakdown(intervals, wall_s, classify=lambda name: name, top=8):
    """Device time of a profiled run: busy time (union of kernel and copy
    intervals), the idle share of ``wall_s``, and time by kernel group
    (``classify(kernel name) -> group``)."""
    import collections

    spans, groups, names = [], collections.Counter(), collections.Counter()
    for name, t0, t1 in intervals:
        spans.append((t0, t1))
        groups[classify(name)] += (t1 - t0) / 1e3
        names[name[:90]] += (t1 - t0) / 1e3
    busy_ms = _union(spans) / 1e3
    return dict(wall_ms=1e3 * wall_s, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / (1e3 * wall_s),
                device_events=len(spans),
                groups_ms=dict(groups.most_common()),
                top_kernels_ms=names.most_common(top))


# tensorflowonspark_tpu_torch/serving/decode/loadgen.py:36-38 (the seeded
# stdlib generator and the token draw of shared_prefix_prompts: ids in
# [1, vocab), 0 left out) and :98-102 (run_open_loop's exponential
# inter-arrival draw)
def draw_tokens(rng, n, vocab_size):
    """``n`` token ids in ``[1, vocab_size)`` from a ``random.Random``."""
    return [rng.randrange(1, int(vocab_size)) for _ in range(int(n))]


def arrivals(rng, n, rate_rps):
    """``n`` Poisson arrival offsets (seconds) at ``rate_rps``."""
    out, t = [], 0.0
    for _ in range(int(n)):
        out.append(t)
        t += rng.expovariate(float(rate_rps))
    return out


def stdlib_rng(seed):
    """The generator the load generator seeds (``random.Random``)."""
    return random.Random(seed)
