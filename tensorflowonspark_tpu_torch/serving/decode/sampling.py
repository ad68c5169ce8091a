"""Seeded, replayable token sampling for the decode tier.

A copy of ``tensorflowonspark_tpu/serving/decode/sampling.py``: numpy
only, so the port draws bit-identical tokens from the same logits.  The
invariant: a sampled token is a PURE FUNCTION of ``(logits, params,
index)`` — no hidden RNG state threaded step to step — so a replay of a
session re-draws the identical stream.

Per-index keying uses ``numpy.random.default_rng([seed, index])`` —
``SeedSequence`` spawning is deterministic across processes and
platforms (PCG64), unlike ``random.Random(seed); N draws``.
"""

from __future__ import annotations

import numpy as np

_SEED_MASK = 0x7FFFFFFF


def make(temperature=None, top_k=None, top_p=None, seed=None):
    """Validate request-level sampling knobs into the picklable params
    dict the dispatch blob carries (None == greedy argmax).

    ``temperature`` <= 0 (or unset) means greedy; ``top_k`` keeps the k
    highest logits; ``top_p`` keeps the smallest nucleus of cumulative
    probability >= p; ``seed`` keys the per-index RNG.  Raises
    ValueError on out-of-range values (the HTTP frontend maps it to
    400)."""
    if temperature is None and top_k is None and top_p is None \
            and seed is None:
        return None
    temperature = 0.0 if temperature is None else float(temperature)
    if not np.isfinite(temperature) or temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None:
        top_k = int(top_k)
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None:
        top_p = float(top_p)
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature == 0.0:
        return None  # top_k/top_p are no-ops under argmax
    seed = 0 if seed is None else int(seed)
    return {"temperature": temperature, "top_k": top_k, "top_p": top_p,
            "seed": seed & _SEED_MASK}


def is_greedy(params):
    return not params or not params.get("temperature")


def sample_token(logits, params, index):
    """One token from a logits row — pure in ``(logits, params, index)``.

    ``logits``: [vocab] float row (numpy or anything asarray-able);
    ``params``: the dict from :func:`make` (None == greedy);
    ``index``: the session's token index, which keys the RNG so a
    failover replay (or a speculative verify) of the same index draws
    the same uniform variate."""
    logits = np.asarray(logits, np.float64).reshape(-1)
    if is_greedy(params):
        return int(np.argmax(logits))
    z = logits / float(params["temperature"])
    top_k = params.get("top_k")
    if top_k and top_k < z.size:
        kth = np.partition(z, -top_k)[-top_k]
        z = np.where(z >= kth, z, -np.inf)
    p = np.exp(z - np.max(z))
    p /= p.sum()
    top_p = params.get("top_p")
    if top_p and top_p < 1.0:
        order = np.argsort(-p, kind="stable")
        csum = np.cumsum(p[order])
        keep = int(np.searchsorted(csum, top_p) + 1)
        mask = np.zeros(p.size, bool)
        mask[order[:keep]] = True
        p = np.where(mask, p, 0.0)
        p /= p.sum()
    rng = np.random.default_rng([int(params["seed"]), int(index)])
    u = rng.random()
    idx = int(np.searchsorted(np.cumsum(p), u, side="right"))
    return min(idx, p.size - 1)
