"""Iteration-level continuous batcher for autoregressive decode.

Counterpart of ``tensorflowonspark_tpu/serving/decode/scheduler.py``:
the same replica-side loop, with the model steps in PyTorch.

- Requests admit into free KV-cache slots mid-flight; each iteration
  runs (1) prefill for newly admitted prompts, bucketed by sequence
  length and rows, then (2) one fused decode step over every occupied
  slot; a finished sequence retires its slot at once.
- Block-paged KV with prefix sharing (``TFOS_DECODE_PAGED``): admission
  matches each prompt against the resident prefix trie, maps the shared
  blocks and prefills only the unmatched tail
  (``models/transformer.prefill_extend``).
- Seeded sampling (``serving/decode/sampling.py``): logits come back to
  the host and the token is a pure function of ``(logits, params,
  index)``.
- Speculative decoding (``spec_window`` and a draft model): the draft
  proposes K-1 tokens, one windowed ``decode_step_paged`` over the
  K-token window verifies them, and a draft token is accepted iff it
  equals the target's seeded sample at that index, so speculative
  output equals plain output token for token at the same seed.

Tokens stream back to the driver-side :class:`PendingSession`, whose
index-keyed ledger resolves once: a failover replay after a replica
SIGKILL re-delivers identical ``(index, token)`` pairs (greedy and
seeded sampling are deterministic), so the first arrival wins and no
token is dropped or duplicated.

Hot reload (:meth:`DecodeEngine.set_params`) swaps the params at an
iteration boundary on the engine's own thread, after placing and
casting them there as at start.  Sessions in flight keep their cached
K/V, as in the JAX package; the resident prefixes of the paged cache's
trie are dropped, so that no later session maps K/V of the old params.
The draft model is not swapped: a reload changes the target only, as in
the JAX package.

Module import is stdlib + numpy; torch and the model load on the
engine's thread.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.actors.ledger import IndexLedger, ResolveOnce
from tensorflowonspark_tpu_torch.serving import batcher as _batcher
from tensorflowonspark_tpu_torch.serving.decode import sampling as _sampling
from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)

SLOTS_ENV = "TFOS_DECODE_SLOTS"
QUEUE_MAX_ENV = "TFOS_DECODE_QUEUE_MAX"
MAX_TOKENS_ENV = "TFOS_DECODE_MAX_TOKENS"
PAGED_ENV = "TFOS_DECODE_PAGED"
BLOCK_ENV = "TFOS_DECODE_BLOCK"
PREFIX_SHARING_ENV = "TFOS_DECODE_PREFIX_SHARING"
SPEC_WINDOW_ENV = "TFOS_DECODE_SPEC_WINDOW"


def slots_default():
    return int(os.environ.get(SLOTS_ENV, "8"))


def queue_max_default():
    return int(os.environ.get(QUEUE_MAX_ENV, "64"))


def max_tokens_default():
    return int(os.environ.get(MAX_TOKENS_ENV, "64"))


def paged_default():
    return os.environ.get(PAGED_ENV, "1") != "0"


def block_size_default():
    return int(os.environ.get(BLOCK_ENV, "16"))


def prefix_sharing_default():
    return os.environ.get(PREFIX_SHARING_ENV, "1") != "0"


def spec_window_default():
    return int(os.environ.get(SPEC_WINDOW_ENV, "4"))


class DecodeSpec:
    """The decode tier's config.

    ``cfg`` is a ``models/transformer.Config``; ``slots`` sizes the KV
    cache; ``eos_id``/``max_tokens`` are per-session defaults a request
    may override (``max_tokens`` is clamped to ``max_seq - len(prompt)``).
    ``paged`` selects :class:`~.kvcache.PagedKVCache` over
    :class:`~.kvcache.SlotKVCache`; ``block_size``/``num_blocks`` size
    it; ``prefix_sharing`` arms the prefix trie.  Speculative decoding
    arms when both ``draft_params`` (a draft transformer's params: float32
    tensors, or numpy arrays in the JAX package's layout, which the
    engine converts) and ``draft_cfg`` are given: the draft proposes ``spec_window - 1``
    tokens an iteration (default ``TFOS_DECODE_SPEC_WINDOW``, 4) and one
    windowed verify step scores them (paged mode only: the verify step is
    ``decode_step_paged``).  The spec, draft included, rides the replica
    pool's payload, a plain pickle.
    """

    def __init__(self, cfg, slots=None, eos_id=None, max_tokens=None,
                 paged=None, block_size=None, num_blocks=None,
                 prefix_sharing=None, draft_params=None, draft_cfg=None,
                 spec_window=None):
        self.cfg = cfg
        self.slots = int(slots or slots_default())
        self.eos_id = eos_id
        self.max_tokens = int(max_tokens or max_tokens_default())
        self.paged = paged_default() if paged is None else bool(paged)
        self.block_size = int(block_size or block_size_default())
        self.num_blocks = num_blocks
        self.prefix_sharing = (prefix_sharing_default()
                               if prefix_sharing is None
                               else bool(prefix_sharing))
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_window = int(spec_window or spec_window_default())
        if self.spec_window < 2:
            raise ValueError(
                f"spec_window must be >= 2, got {self.spec_window}")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError(
                "speculative decoding needs BOTH draft_params and "
                "draft_cfg (or neither)")
        if draft_params is not None and not self.paged:
            raise ValueError(
                "speculative decoding requires paged=True (the verify "
                "step is decode_step_paged)")

    @property
    def speculative(self):
        return self.draft_params is not None


class PendingSession(ResolveOnce):
    """One decode session's future, driver side: a streaming token
    ledger plus the resolve-once result, as ``batcher.PendingResult``.

    The :class:`~tensorflowonspark_tpu_torch.actors.ledger.IndexLedger`
    keys on token index: after a replica SIGKILL the session re-prefills
    on a survivor and re-streams the same ``(index, token)`` pairs (the
    ``sampling`` dict, seed included, rides the dispatch blob), so the
    first arrival of an index wins, its timestamp included, and a
    duplicate ``gen_done`` is swallowed by the resolve-once gate.
    """

    __slots__ = ("id", "prompt", "max_tokens", "eos_id", "sampling",
                 "trace", "route_id", "t_submit", "_ledger")

    def __init__(self, sid, prompt, max_tokens, eos_id, sampling=None,
                 trace=None, route_id=None):
        super().__init__()
        self.id = sid
        self.prompt = [int(t) for t in prompt]
        self.max_tokens = int(max_tokens)
        self.eos_id = eos_id
        self.sampling = sampling
        self.route_id = route_id   # the fabric's affinity key
        self.trace = trace         # W3C traceparent string, or None
        self.t_submit = time.perf_counter()
        self._ledger = IndexLedger()   # index -> token, first arrival wins

    def tokens_so_far(self):
        return [int(t) for t in self._ledger.values()]

    def result(self, timeout=None):
        """Block for the session result dict (``tokens``, ``ttft_ms``,
        ``token_ms`` gaps, ``total_ms`` and the engine's meta); raises
        the session's error or TimeoutError."""
        timeout = (_batcher.request_timeout_default()
                   if timeout is None else timeout)
        return self.wait(timeout, "decode session not done")

    # -- resolve-once plumbing (the pool's collector calls these) -----------
    def _token(self, index, token):
        """Record one streamed token; False for an index already held
        (a replay's duplicate, dropped)."""
        return self._ledger.record(index, int(token))

    def _set(self, tokens, meta):
        if self.done():
            return
        now = time.perf_counter()
        times = self._ledger.times()
        gaps = []
        order = sorted(times)
        for a, b in zip(order, order[1:]):
            if b == a + 1:  # only adjacent indices time a real gap
                gaps.append((times[b] - times[a]) * 1e3)
        self.resolve({
            "tokens": [int(t) for t in tokens],
            "ttft_ms": (round((times[0] - self.t_submit) * 1e3, 3)
                        if 0 in times else None),
            "token_ms": [round(g, 3) for g in gaps],
            "total_ms": round((now - self.t_submit) * 1e3, 3),
            **(meta or {}),
        })

    def _fail(self, exc):
        self.reject(exc)


class _Slot:
    """Replica-side per-slot generation state."""

    __slots__ = ("sid", "prompt_len", "generated", "max_tokens", "eos_id",
                 "sampling", "trace", "last", "t_admit")

    def __init__(self, sid, prompt_len, max_tokens, eos_id, first_token,
                 sampling=None, trace=None):
        self.sid = sid
        self.prompt_len = prompt_len
        self.max_tokens = max_tokens
        self.eos_id = eos_id
        self.sampling = sampling
        self.trace = trace
        self.generated = [first_token]
        self.last = first_token
        self.t_admit = time.perf_counter()


class DecodeEngine:
    """The replica-side continuous-batching loop.

    ``emit(kind, sid, *payload)`` is the wire back to the caller:
    ``("token", sid, index, token)`` per generated token,
    ``("done", sid, tokens, meta)`` at retirement,
    ``("error", sid, message)`` on a per-session failure.

    ``params`` is the model's params dict (float32 tensors, e.g. from
    ``transformer.init`` or ``transformer.params_from_jax``);
    ``device=None`` means ``cuda``, and :meth:`start` raises when no
    CUDA device is present — pass ``device="cpu"`` for the CPU.  The
    engine thread moves the params (and a speculative spec's draft
    params) to the device, casts the matmul weights to the compute dtype
    once, and runs every step under ``torch.inference_mode()``.
    """

    def __init__(self, params, spec, emit, replica=0, device=None):
        self._params = params
        self._new_params = None     # set_params' tree, taken by _run
        self._spec = spec
        self._emit = emit
        self._replica = replica
        self._device_arg = device
        self._device = None
        self._q = collections.deque()
        self._qlock = threading.Lock()
        self._sids = set()          # sids queued or active (dedupe)
        self._active = {}           # slot index -> _Slot
        self._cache = None          # engine-thread cache, read by stats()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = None
        self._started = threading.Event()
        self._init_error = None
        self.iterations = 0
        self.prefills = 0           # prefill calls, plain and tail
        self.extends = 0            # of which prefix-hit tail prefills
        self.retired = 0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.reloads = 0
        self.spec_proposed = 0
        self.spec_accepted = 0

    # -- lifecycle ----------------------------------------------------------
    def start(self, timeout=120.0):
        if self._thread is None:
            self._device = resolve_device(self._device_arg)
            self._thread = threading.Thread(
                target=self._run, name="tfos-decode-engine", daemon=True)
            self._thread.start()
        if not self._started.wait(timeout):
            raise TimeoutError("decode engine did not start")
        if self._init_error is not None:
            raise self._init_error
        return self

    def stop(self, timeout=10.0):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def set_params(self, params):
        """Hot-reload hook: the engine thread takes ``params`` at its next
        iteration boundary, places and casts them on its device
        (``transformer.compute_params``) and swaps.  Sessions in flight
        finish with their cached K/V plus the new params' compute, as in
        the JAX package; the prefix trie is dropped."""
        with self._qlock:
            self._new_params = params
        self._wake.set()

    def submit(self, sid, prompt, max_tokens=None, eos_id=None,
               sampling=None, trace=None):
        """Queue one session; admission happens at the next iteration.
        Rejections (prompt too long, duplicate sid) are emitted as
        session errors, not raised."""
        cfg = self._spec.cfg
        prompt = [int(t) for t in prompt]
        if not prompt or len(prompt) > cfg.max_seq - 1:
            self._emit("error", sid,
                       f"prompt length {len(prompt)} not in [1, "
                       f"{cfg.max_seq - 1}] (max_seq {cfg.max_seq})")
            return
        with self._qlock:
            if sid in self._sids:
                return              # re-send of a live session
            self._sids.add(sid)
            self._q.append({
                "sid": sid, "prompt": prompt,
                "max_tokens": int(max_tokens or self._spec.max_tokens),
                "eos_id": self._spec.eos_id if eos_id is None else eos_id,
                "sampling": sampling, "trace": trace,
                "t_queued": time.perf_counter(),
            })
        self._wake.set()

    def stats(self):
        with self._qlock:
            queued = len(self._q)
        out = {
            "iterations": self.iterations,
            "prefills": self.prefills,
            "extends": self.extends,
            "retired": self.retired,
            "active": len(self._active),
            "queued": queued,
            "slots": self._spec.slots,
            "paged": self._spec.paged,
            "reloads": self.reloads,
        }
        if self._spec.paged:
            cache = self._cache
            out["prefix_hits"] = self.prefix_hits
            out["prefix_tokens_saved"] = self.prefix_tokens_saved
            out["blocks_in_use"] = (cache.blocks_in_use
                                    if cache is not None else 0)
        if self._spec.speculative:
            out["spec_proposed"] = self.spec_proposed
            out["spec_accepted"] = self.spec_accepted
            out["spec_accept_rate"] = round(
                self.spec_accepted / max(1, self.spec_proposed), 4)
        return out

    # -- engine thread ------------------------------------------------------
    def _build_caches(self):
        """The target's cache and, for a speculative spec, the draft's
        slot cache (else None)."""
        spec = self._spec
        if spec.paged:
            cache = self._kvcache_mod.PagedKVCache(
                spec.cfg, spec.slots, block_size=spec.block_size,
                num_blocks=spec.num_blocks,
                prefix_sharing=spec.prefix_sharing, device=self._device)
        else:
            cache = self._kvcache_mod.SlotKVCache(
                spec.cfg, spec.slots, device=self._device)
        dcache = None
        if spec.speculative:
            dcache = self._kvcache_mod.SlotKVCache(
                spec.draft_cfg, spec.slots, device=self._device)
        self._cache = cache
        return cache, dcache

    def _run(self):
        try:
            import torch

            from tensorflowonspark_tpu_torch.models import transformer
            from tensorflowonspark_tpu_torch.serving.decode import kvcache

            if self._device.type == "cuda":
                # the current device is per thread
                torch.cuda.set_device(self._device)
            self._transformer = transformer
            self._kvcache_mod = kvcache
            spec = self._spec
            with torch.inference_mode():
                self._params = transformer.compute_params(
                    self._params, spec.cfg, self._device)
                self._draft = (self._draft_params(transformer)
                               if spec.speculative else None)
                cache, dcache = self._build_caches()
        except BaseException as e:  # noqa: BLE001 - surface via start()
            self._init_error = e
            self._started.set()
            return
        self._started.set()
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    faults.check("decode.step", replica=self._replica)
                    self._take_new_params(cache)
                    self._admit(cache, dcache)
                    if not self._active:
                        self._wake.wait(0.02)
                        self._wake.clear()
                        continue
                    if self._spec.paged:
                        self._iterate_paged(cache, dcache)
                    else:
                        self._iterate(cache)
                except BaseException as e:  # noqa: BLE001 - fail the
                    # cohort, rebuild the caches, keep the replica serving
                    logger.exception("decode engine iteration failed")
                    self._fail_all(repr(e))
                    cache, dcache = self._build_caches()

    def _draft_params(self, transformer):
        """The draft's params placed and cast on the engine's device; a
        tree of numpy arrays (the JAX package's layout, as an export
        holds) is converted first."""
        import torch

        spec = self._spec
        tree = spec.draft_params
        if not torch.is_tensor(tree["embed"]):
            tree = transformer.params_from_jax(tree, spec.draft_cfg,
                                               device="cpu")
        return transformer.compute_params(tree, spec.draft_cfg, self._device)

    def _take_new_params(self, cache):
        """Swap in :meth:`set_params`' tree, if one is waiting."""
        with self._qlock:
            params, self._new_params = self._new_params, None
        if params is None:
            return
        self._params = self._transformer.compute_params(
            params, self._spec.cfg, self._device)
        if self._spec.paged:
            cache.drop_prefixes()
        self.reloads += 1

    # -- admission ----------------------------------------------------------
    def _admit(self, cache, dcache=None):
        """Move queued sessions into free slots.

        Paged mode: each prompt is first matched against the prefix
        trie; a hit maps the shared blocks and only the unmatched tail
        runs ``prefill_extend``, grouped by (tail bucket, prefix-block
        bucket).  Misses (and slot mode) run the plain bucketed
        ``prefill``.  Every admitted prompt's whole-block prefix is then
        offered to the trie.  The first token comes from the prefill
        logits either way (sampled at index 0).  A speculative engine
        also prefills each whole prompt through the draft (bucketed the
        same way) and installs its K/V in the draft's slot cache.
        """
        batch = []
        with self._qlock:
            if self._new_params is not None:
                # a session queued after set_params must meet the new
                # params: the next iteration swaps them in first
                return
            while self._q and len(batch) < cache.free_slots:
                batch.append(self._q.popleft())
        if not batch:
            return
        T = self._transformer
        params = self._params
        cfg = self._spec.cfg
        paged = self._spec.paged
        plain, matched = [], []
        for req in batch:
            shared, mlen = (cache.match_prefix(req["prompt"])
                            if paged else ([], 0))
            if mlen > 0:
                matched.append((req, shared, mlen))
            else:
                plain.append(req)

        admitted = []  # (req, logits_row [vocab], k_i, v_i, shared, mlen)
        # -- plain bucketed prefill (whole prompt) --------------------------
        groups = {}
        for req in plain:
            t = _batcher.bucket_seq(len(req["prompt"]), cfg.max_seq)
            groups.setdefault(t, []).append(req)
        for t, members in groups.items():
            rows = _batcher.bucket_size(len(members), self._spec.slots)
            toks = np.stack([
                _batcher.pad_seq(np.asarray(m["prompt"], np.int32), t)
                for m in members])
            lens = np.asarray([len(m["prompt"]) for m in members], np.int32)
            toks = _batcher.pad_rows(toks, rows)
            lens = _batcher.pad_rows(lens, rows)
            logits, k, v = T.prefill(params, toks, cfg, lengths=lens)
            logits = logits.float().cpu().numpy()
            self.prefills += 1
            for i, req in enumerate(members):
                admitted.append((req, logits[i], k[i], v[i], [], 0))
        # -- prefix-hit tail prefill ----------------------------------------
        groups = {}
        for req, shared, mlen in matched:
            tail = len(req["prompt"]) - mlen
            key = (_batcher.bucket_seq(tail, cfg.max_seq),
                   _batcher.bucket_size(len(shared),
                                        cache.blocks_per_slot))
            groups.setdefault(key, []).append((req, shared, mlen))
        for (t, nbp), members in groups.items():
            rows = _batcher.bucket_size(len(members), self._spec.slots)
            toks = np.stack([
                _batcher.pad_seq(
                    np.asarray(m[0]["prompt"][m[2]:], np.int32), t)
                for m in members])
            lens = np.asarray(
                [len(m[0]["prompt"]) - m[2] for m in members], np.int32)
            ptab = np.zeros((len(members), nbp), np.int32)
            for i, (_req, shared, _mlen) in enumerate(members):
                ptab[i, :len(shared)] = shared
            plens = np.asarray([m[2] for m in members], np.int32)
            toks = _batcher.pad_rows(toks, rows)
            lens = _batcher.pad_rows(lens, rows)
            ptab = _batcher.pad_rows(ptab, rows)
            plens = _batcher.pad_rows(plens, rows)
            logits, k, v = T.prefill_extend(
                params, toks, cfg, cache.k, cache.v, ptab, plens,
                lengths=lens)
            logits = logits.float().cpu().numpy()
            self.prefills += 1
            self.extends += 1
            for i, (req, shared, mlen) in enumerate(members):
                admitted.append((req, logits[i], k[i], v[i], shared, mlen))
                self.prefix_hits += 1
                self.prefix_tokens_saved += mlen
                metrics_registry.inc("tfos_decode_prefix_hits")
        # -- draft prefill (speculative: whole prompt, own cache) -----------
        draft_kv = {}  # sid -> (k_i, v_i)
        if dcache is not None:
            dcfg = self._spec.draft_cfg
            groups = {}
            for req in batch:
                t = _batcher.bucket_seq(len(req["prompt"]), dcfg.max_seq)
                groups.setdefault(t, []).append(req)
            for t, members in groups.items():
                rows = _batcher.bucket_size(len(members), self._spec.slots)
                toks = np.stack([
                    _batcher.pad_seq(np.asarray(m["prompt"], np.int32), t)
                    for m in members])
                lens = np.asarray([len(m["prompt"]) for m in members],
                                  np.int32)
                toks = _batcher.pad_rows(toks, rows)
                lens = _batcher.pad_rows(lens, rows)
                _, dk, dv = T.prefill(self._draft, toks, dcfg, lengths=lens)
                for i, req in enumerate(members):
                    draft_kv[req["sid"]] = (dk[i], dv[i])

        # -- slot installation + first-token emission -----------------------
        for req, logits_row, k_i, v_i, shared, mlen in admitted:
            plen = len(req["prompt"])
            slot = cache.alloc()
            # cannot be None: admission is bounded by free_slots
            if paged:
                bs = cache.block_size
                own = cache.alloc_blocks(-(-(plen - mlen) // bs))
                cache.map_session(slot, shared, own, plen)
                cache.insert_tail(slot, k_i, v_i, mlen, plen - mlen)
                cache.register_prompt(slot, req["prompt"])
            else:
                cache.insert(slot, k_i, v_i, plen)
            if dcache is not None:
                dk, dv = draft_kv[req["sid"]]
                dcache.insert(slot, dk, dv, plen)
            first = _sampling.sample_token(logits_row, req["sampling"], 0)
            mt = min(req["max_tokens"], cache.max_seq - plen)
            st = _Slot(req["sid"], plen, max(1, mt), req["eos_id"], first,
                       req["sampling"], trace=req.get("trace"))
            self._active[slot] = st
            with telemetry.activate(st.trace):
                telemetry.event(
                    telemetry.DECODE_ADMIT, sid=st.sid, slot=slot,
                    prompt_len=plen, prefix_hit_len=mlen,
                    queue_ms=round((time.perf_counter()
                                    - req.get("t_queued", time.perf_counter()))
                                   * 1e3, 3))
            self._emit("token", st.sid, 0, first)
            if (st.eos_id is not None and first == st.eos_id) \
                    or st.max_tokens <= 1:
                self._retire(cache, slot)
        metrics_registry.set_gauge("tfos_decode_slot_occupancy",
                                   cache.occupancy)
        if paged:
            metrics_registry.set_gauge("tfos_decode_blocks_in_use",
                                       cache.blocks_in_use)

    # -- iteration: slot cache ----------------------------------------------
    def _iterate(self, cache):
        """One fused decode step over every occupied slot."""
        tokens = np.zeros((cache.slots,), np.int32)
        for slot, st in self._active.items():
            tokens[slot] = st.last
        logits, cache.k, cache.v = self._transformer.decode_step(
            self._params, tokens, self._spec.cfg, cache.k, cache.v,
            cache.lengths)
        logits = logits.float().cpu().numpy()
        self.iterations += 1
        for slot in list(self._active):
            st = self._active[slot]
            cache.lengths[slot] += 1
            tok = _sampling.sample_token(logits[slot], st.sampling,
                                         len(st.generated))
            st.generated.append(tok)
            st.last = tok
            self._emit("token", st.sid, len(st.generated) - 1, tok)
            if (st.eos_id is not None and tok == st.eos_id) \
                    or len(st.generated) >= st.max_tokens \
                    or cache.lengths[slot] >= cache.max_seq:
                self._retire(cache, slot)
        metrics_registry.set_gauge("tfos_decode_slot_occupancy",
                                   cache.occupancy)

    # -- iteration: paged cache ---------------------------------------------
    def _iterate_paged(self, cache, dcache=None):
        """One fused windowed step over every occupied slot.

        Without a draft the window is one token: the plain paged step.
        With one, the draft runs K ``decode_step``s over the window
        ``[last, d_1 .. d_{K-1}]``, sampling ``d_j`` at its future index
        ``len(generated) + j - 1``; one ``decode_step_paged`` verifies the
        window, and ``d_j`` is accepted iff it equals the target's seeded
        sample at that index, so every emitted token is the target's
        sample on a correct history.  The draft ingests all K window
        tokens (only active slots advance); both cursors then roll back to
        the accepted prefix by assignment, and the stale K/V past a
        cursor is masked by length until a later write lands on it.
        """
        spec = self._spec
        T = self._transformer
        k_win = spec.spec_window if dcache is not None else 1
        window = np.zeros((cache.slots, k_win), np.int32)
        for slot, st in self._active.items():
            window[slot, 0] = st.last
        n0 = cache.lengths.copy()
        if dcache is not None:
            for j in range(k_win):
                dlogits, dcache.k, dcache.v = T.decode_step(
                    self._draft, window[:, j], spec.draft_cfg, dcache.k,
                    dcache.v, dcache.lengths)
                for slot in self._active:
                    dcache.lengths[slot] += 1
                if j < k_win - 1:
                    dlogits = dlogits.float().cpu().numpy()
                    for slot, st in self._active.items():
                        window[slot, j + 1] = _sampling.sample_token(
                            dlogits[slot], st.sampling,
                            len(st.generated) + j)
        for slot in self._active:
            cache.ensure_capacity(slot, int(n0[slot]) + k_win)
        logits, cache.k, cache.v = T.decode_step_paged(
            self._params, window, spec.cfg, cache.k, cache.v,
            cache.block_tables, n0)
        logits = logits.float().cpu().numpy()           # [slots, K, vocab]
        self.iterations += 1
        for slot in list(self._active):
            st = self._active[slot]
            n = int(n0[slot])
            base = len(st.generated)
            # rows past max_seq wrote their token's k/v to the sentinel,
            # so their logits miss history: never emit from them
            valid = min(k_win, cache.max_seq - n)
            emitted = []
            for j in range(valid):
                if j > 0 and int(window[slot, j]) != emitted[j - 1]:
                    break               # draft diverged; later rows stale
                if j > 0:
                    self.spec_accepted += 1
                emitted.append(_sampling.sample_token(
                    logits[slot, j], st.sampling, base + j))
            if dcache is not None:
                self.spec_proposed += k_win - 1
            done = False
            for tok in emitted:
                st.generated.append(tok)
                st.last = tok
                cache.lengths[slot] += 1
                self._emit("token", st.sid, len(st.generated) - 1, tok)
                if (st.eos_id is not None and tok == st.eos_id) \
                        or len(st.generated) >= st.max_tokens:
                    done = True
                    break
            if dcache is not None:
                # roll the draft cursor back onto the accepted prefix
                dcache.lengths[slot] = cache.lengths[slot]
            if done or cache.lengths[slot] >= cache.max_seq:
                self._retire(cache, slot)
        metrics_registry.set_gauge("tfos_decode_slot_occupancy",
                                   cache.occupancy)
        metrics_registry.set_gauge("tfos_decode_blocks_in_use",
                                   cache.blocks_in_use)
        if dcache is not None:
            metrics_registry.set_gauge(
                "tfos_decode_spec_accept",
                round(self.spec_accepted / max(1, self.spec_proposed), 4))

    def _retire(self, cache, slot):
        st = self._active.pop(slot)
        cache.retire(slot)
        with self._qlock:
            self._sids.discard(st.sid)
        self.retired += 1
        metrics_registry.inc("tfos_decode_retired_total")
        gen_ms = round((time.perf_counter() - st.t_admit) * 1e3, 3)
        with telemetry.activate(st.trace):
            telemetry.record_span(
                telemetry.DECODE_RETIRE, gen_ms / 1e3, sid=st.sid,
                tokens=len(st.generated), prompt_len=st.prompt_len,
                replica=self._replica)
        self._emit("done", st.sid, list(st.generated), {
            "replica": self._replica,
            "prompt_len": st.prompt_len,
            "gen_ms": gen_ms,
        })

    def _fail_all(self, message):
        with self._qlock:
            queued = list(self._q)
            self._q.clear()
            self._sids.clear()
        for req in queued:
            self._emit("error", req["sid"], message)
        for st in self._active.values():
            self._emit("error", st.sid, message)
        self._active.clear()
