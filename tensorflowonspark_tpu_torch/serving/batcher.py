"""Sequence and batch bucketing helpers for the decode tier.

Own copies of the helpers the decode engine uses from
``tensorflowonspark_tpu/serving/batcher.py`` (the micro-batcher itself
belongs to the predict path and is not ported).  numpy only.
"""

from __future__ import annotations

import os

import numpy as np

MAX_BATCH_ENV = "TFOS_SERVE_MAX_BATCH"
TIMEOUT_ENV = "TFOS_SERVE_TIMEOUT"


def max_batch_default():
    return int(os.environ.get(MAX_BATCH_ENV, "64"))


def request_timeout_default():
    return float(os.environ.get(TIMEOUT_ENV, "30"))


def bucket_size(n, cap=None):
    """Smallest power of two >= n, capped at ``cap`` (default
    TFOS_SERVE_MAX_BATCH).  The cap itself is always a legal bucket even
    when it is not a power of two — a full batch pads nothing."""
    cap = max_batch_default() if cap is None else int(cap)
    if n >= cap:
        return cap
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


def bucket_seq(n, cap):
    """Smallest power of two >= n, capped at ``cap`` (the cap itself is
    always a legal bucket).  Same rounding as :func:`bucket_size` but on
    a sequence axis: variable-length prompts compile one executable per
    bucket instead of one per distinct length (or all at max_seq)."""
    cap = int(cap)
    if n >= cap:
        return cap
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


def pad_rows(arr, target):
    """Pad ``arr`` along axis 0 up to ``target`` rows by edge-replication
    (real rows repeated, so padded compute stays numerically in-domain —
    no NaN-able zeros into normalization layers)."""
    arr = np.asarray(arr)
    n = arr.shape[0] if arr.ndim else 0
    if arr.ndim == 0:
        raise ValueError("pad_rows needs at least one (batch) axis")
    if n == target:
        return arr
    if n > target:
        raise ValueError(f"cannot pad {n} rows down to {target}")
    if n == 0:
        raise ValueError("cannot pad an empty batch (no row to replicate)")
    widths = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, mode="edge")


def pad_seq(arr, target, axis=0):
    """Pad ``arr`` along a SEQUENCE axis up to ``target`` by
    edge-replication (the last real step repeated, so padded positions
    stay in-domain — token ids remain valid vocabulary entries).

    Attention-mask safety is split with the model: edge values keep the
    compute finite/in-domain, and the consumer masks padded positions
    using the true lengths shipped alongside
    (``transformer.prefill(lengths=...)`` reads its final REAL position
    and never attends past it causally)."""
    arr = np.asarray(arr)
    if arr.ndim <= axis:
        raise ValueError(f"array rank {arr.ndim} has no axis {axis}")
    n = arr.shape[axis]
    if n == target:
        return arr
    if n > target:
        raise ValueError(f"cannot pad seq {n} down to {target}")
    if n == 0:
        raise ValueError("cannot pad an empty sequence")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(arr, widths, mode="edge")
