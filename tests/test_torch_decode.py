"""PyTorch port, serving/decode/: KV-cache bookkeeping, seeded sampling
and the CPU DecodeEngine held token-for-token against the JAX package's
full-recompute greedy oracle, plus the no-fallback contract (no CUDA ->
the engine's default device refuses to start, chip_smoke.py fails).

Mirrors the kvcache units and parity gates of tests/test_decode.py.
"""

import functools
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402

from tensorflowonspark_tpu import ops as jops  # noqa: E402
from tensorflowonspark_tpu.models import transformer as JT  # noqa: E402
from tensorflowonspark_tpu.serving.decode import (  # noqa: E402
    sampling as jsampling,
)
from tensorflowonspark_tpu_torch.models import transformer as TT  # noqa: E402
from tensorflowonspark_tpu_torch.serving import decode as D  # noqa: E402
from tensorflowonspark_tpu_torch.serving.decode import (  # noqa: E402
    kvcache,
    sampling,
)

pytestmark = pytest.mark.decode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(vocab_size=61, dim=32, n_layers=2, n_heads=2, max_seq=32,
          dtype="float32")


def _cfg(**kw):
    return TT.Config(**{**KW, "attn_impl": "flash", **kw})


@pytest.fixture(scope="module")
def params():
    pj = JT.init(jax.random.PRNGKey(0), JT.Config(**KW))
    pt = TT.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), _cfg(),
                          device="cpu")
    return pj, pt


def _oracle(pj, prompt, **kw):
    return JT.greedy_decode_reference(
        pj, prompt, JT.Config(**KW, attn_impl="reference"),
        attn_fn=functools.partial(jops.mha_reference, causal=True), **kw)


def _run_sessions(params, spec, jobs, timeout=120):
    """Drive a CPU DecodeEngine over ``jobs`` = [(sid, prompt, kw)];
    returns ({sid: tokens}, {sid: [(index, token)]}, stats, engine)."""
    done, streamed, errors = {}, {sid: [] for sid, _, _ in jobs}, {}
    lock = threading.Lock()

    def emit(kind, sid, *rest):
        with lock:
            if kind == "token":
                streamed[sid].append(rest)
            elif kind == "done":
                done[sid] = rest[0]
            else:
                errors[sid] = rest[0]

    eng = D.DecodeEngine(params, spec, emit, device="cpu")
    eng.start(timeout=timeout)
    try:
        for sid, prompt, kw in jobs:
            eng.submit(sid, prompt, **kw)
        deadline = time.time() + timeout
        while len(done) + len(errors) < len(jobs) and time.time() < deadline:
            time.sleep(0.01)
        stats = eng.stats()
    finally:
        eng.stop()
    assert not errors, errors
    assert len(done) == len(jobs), "timed out"
    return done, streamed, stats, eng


# --- KV cache units ---------------------------------------------------------

@pytest.mark.parametrize("build", [
    lambda cfg, tree: TT.params_from_jax(tree, cfg),
    lambda cfg, tree: kvcache.SlotKVCache(cfg, slots=1),
    lambda cfg, tree: kvcache.PagedKVCache(cfg, slots=1, block_size=4),
], ids=["params_from_jax", "SlotKVCache", "PagedKVCache"])
def test_entry_points_default_to_the_card(params, monkeypatch, build):
    """Without ``device=`` the weights and the caches go to the card, as
    every entry point does: with no CUDA present the call raises
    ``resolve_device``'s error instead of landing on the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = jax.tree_util.tree_map(np.asarray, params[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(_cfg(), tree)


def test_kvcache_slot_lifecycle_and_insert():
    cfg = _cfg()
    cache = kvcache.SlotKVCache(cfg, slots=3, device="cpu")
    assert tuple(cache.k.shape) == (3, 2, 2, 32, 16)
    assert bool((cache.k == 0).all())  # pools start at zero
    assert cache.free_slots == 3 and cache.occupancy == 0
    assert [cache.alloc() for _ in range(3)] == [0, 1, 2]
    assert cache.alloc() is None
    k = torch.ones((2, 2, 5, 16))
    cache.insert(1, k, 2 * k, 5)
    assert cache.lengths[1] == 5 and cache.occupancy == 3
    assert bool((cache.v[1, :, :, :5] == 2).all())
    assert bool((cache.k[1, :, :, 5:] == 0).all())
    cache.retire(1)
    assert cache.lengths[1] == 0 and cache.free_slots == 1
    with pytest.raises(ValueError):
        cache.retire(1)
    assert cache.alloc() == 1


def test_paged_kvcache_lifecycle_refcounts_and_prefix_match():
    cache = kvcache.PagedKVCache(_cfg(), slots=2, block_size=4,
                                 device="cpu")
    assert tuple(cache.k.shape) == (cache.num_blocks, 2, 2, 4, 16)
    assert cache.blocks_per_slot == 8
    assert cache.blocks_in_use == 0 and cache.leaked_blocks() == []
    prompt = list(range(1, 11))
    assert cache.match_prefix(prompt) == ([], 0)
    slot = cache.alloc()
    own = cache.alloc_blocks(3)
    assert 0 not in own
    cache.map_session(slot, [], own, 10)
    k = torch.zeros((2, 2, 10, 16))
    cache.insert_tail(slot, k, k, 0, 10)
    cache.register_prompt(slot, prompt)
    assert cache.blocks_in_use == 3 and cache.leaked_blocks() == []
    shared, mtoks = cache.match_prefix(prompt)
    assert mtoks == 8 and shared == own[:2]
    slot2 = cache.alloc()
    cache.map_session(slot2, shared, cache.alloc_blocks(1), 10)
    assert cache.blocks_in_use == 4 and cache.leaked_blocks() == []
    with pytest.raises(ValueError):
        cache.insert_tail(slot2, k, k, 9, 1)
    cache.retire(slot)
    cache.retire(slot2)
    assert cache.occupancy == 0 and cache.blocks_in_use == 2
    assert cache.leaked_blocks() == []
    assert cache.match_prefix(prompt)[1] == 8


def test_paged_kvcache_trie_reclaim_lru_and_oom():
    cfg = _cfg()
    with pytest.raises(ValueError):
        kvcache.PagedKVCache(cfg, slots=1, block_size=4, num_blocks=8,
                             device="cpu")
    cache = kvcache.PagedKVCache(cfg, slots=1, block_size=4, num_blocks=9,
                                 device="cpu")
    prompt = list(range(1, 11))
    slot = cache.alloc()
    cache.map_session(slot, [], cache.alloc_blocks(3), 10)
    cache.register_prompt(slot, prompt)
    cache.retire(slot)
    assert cache.blocks_in_use == 2
    got = cache.alloc_blocks(7)
    assert cache.match_prefix(prompt)[1] == 4
    with pytest.raises(kvcache.CacheOOM):
        cache.alloc_blocks(2)
    assert cache.match_prefix(prompt) == ([], 0)
    for b in got:
        cache._release(b)
    assert cache.blocks_in_use == 0 and cache.leaked_blocks() == []


def test_paged_kvcache_drop_prefixes_keeps_live_sessions():
    """``drop_prefixes`` (the decode engine's hot reload) forgets every
    resident prefix: trie-only blocks return to the free list, blocks a
    live session maps stay until it retires, and no block leaks."""
    cfg = _cfg()
    cache = kvcache.PagedKVCache(cfg, slots=2, block_size=4, device="cpu")
    prompt = list(range(1, 11))
    done, live = cache.alloc(), cache.alloc()
    for slot in (done, live):
        cache.map_session(slot, [], cache.alloc_blocks(3), 10)
    cache.register_prompt(done, prompt)
    cache.register_prompt(live, [7] + prompt[1:])
    cache.retire(done)
    assert cache.blocks_in_use == 5 and cache.match_prefix(prompt)[1] == 8
    assert cache.drop_prefixes() == 4
    assert cache.match_prefix(prompt) == ([], 0)
    assert cache.blocks_in_use == 3 and cache.leaked_blocks() == []
    cache.retire(live)
    assert cache.blocks_in_use == 0 and cache.leaked_blocks() == []


@pytest.mark.parametrize("start,length", [(0, 10), (4, 7), (8, 8)])
def test_insert_tail_edge_pads_on_device_like_numpy(start, length):
    """insert_tail keeps K/V on the device and pads the last block by
    edge replication, exactly as the reference's np.pad(mode='edge')."""
    cache = kvcache.PagedKVCache(_cfg(), slots=1, block_size=4,
                                 device="cpu")
    slot = cache.alloc()
    nb = -(-(start + length) // 4)
    cache.map_session(slot, [], cache.alloc_blocks(nb), start + length)
    rng = np.random.default_rng(start + length)
    k = rng.standard_normal((2, 2, length + 3, 16)).astype(np.float32)
    cache.insert_tail(slot, torch.from_numpy(k), torch.from_numpy(-k),
                      start, length)
    nch = -(-length // 4)
    ref = np.pad(k[:, :, :length],
                 ((0, 0), (0, 0), (0, nch * 4 - length), (0, 0)),
                 mode="edge")
    ref = ref.reshape(2, 2, nch, 4, 16).transpose(2, 0, 1, 3, 4)
    phys = cache.block_tables[slot, start // 4:start // 4 + nch]
    np.testing.assert_array_equal(cache.k[phys].numpy(), ref)
    np.testing.assert_array_equal(cache.v[phys].numpy(), -ref)


# --- sampling ---------------------------------------------------------------

def test_sample_token_matches_jax_package_bit_for_bit():
    rng = np.random.default_rng(0)
    for i in range(8):
        logits = rng.normal(size=61).astype(np.float32)
        for kw in (dict(), dict(temperature=0.8, top_k=12, seed=42),
                   dict(temperature=1.1, top_p=0.9, seed=7),
                   dict(temperature=0.7, top_k=5, top_p=0.8, seed=3)):
            p, pj = sampling.make(**kw), jsampling.make(**kw)
            assert p == pj
            assert [sampling.sample_token(logits, p, j) for j in range(6)] \
                == [jsampling.sample_token(logits, pj, j) for j in range(6)]


# --- engine -----------------------------------------------------------------

def test_spec_refuses_speculative_and_engine_rejects_bad_prompts():
    """A speculative spec is refused as the JAX package refuses it: a
    draft without its config (or the reverse), a window below 2, a
    draft on the slot cache."""
    with pytest.raises(ValueError, match="BOTH"):
        D.DecodeSpec(_cfg(), draft_params={}, draft_cfg=None)
    with pytest.raises(ValueError, match="BOTH"):
        D.DecodeSpec(_cfg(), draft_params=None, draft_cfg=_cfg())
    with pytest.raises(ValueError, match="spec_window"):
        D.DecodeSpec(_cfg(), draft_params={}, draft_cfg=_cfg(),
                     spec_window=1)
    with pytest.raises(ValueError, match="paged"):
        D.DecodeSpec(_cfg(), paged=False, draft_params={},
                     draft_cfg=_cfg())
    events = []
    eng = D.DecodeEngine(None, D.DecodeSpec(_cfg(), slots=2),
                         lambda kind, sid, *rest: events.append((kind, sid)))
    eng.submit("s-empty", [])
    eng.submit("s-long", list(range(32)))
    assert ("error", "s-empty") in events and ("error", "s-long") in events


def test_engine_default_device_refuses_to_start_without_cuda():
    """device=None means CUDA; with none present start() raises and
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device starts")
    eng = D.DecodeEngine({}, D.DecodeSpec(_cfg(), slots=1),
                         lambda *a: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        eng.start(timeout=5)


def test_parity_staggered_mixed_length_token_identical(params):
    """Staggered arrivals, mixed prompt lengths, slots=2 forcing queueing:
    every session's stream equals the JAX greedy oracle, each index
    exactly once and in order."""
    pj, pt = params
    rng = np.random.default_rng(3)
    prompts = {f"s{i}": rng.integers(0, 61, size=n).tolist()
               for i, n in enumerate((5, 3, 9, 12))}
    done, streamed, errors = {}, {sid: [] for sid in prompts}, {}

    def emit(kind, sid, *rest):
        if kind == "token":
            streamed[sid].append(rest)
        elif kind == "done":
            done[sid] = rest[0]
        else:
            errors[sid] = rest[0]

    eng = D.DecodeEngine(pt, D.DecodeSpec(_cfg(), slots=2, max_tokens=6),
                         emit, device="cpu")
    eng.start(timeout=60)
    try:
        eng.submit("s0", prompts["s0"])
        deadline = time.time() + 60
        while not streamed["s0"] and time.time() < deadline:
            time.sleep(0.01)
        for sid in ("s1", "s2", "s3"):
            eng.submit(sid, prompts[sid])
        while len(done) + len(errors) < 4 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        eng.stop()
    assert not errors, errors
    for sid, prompt in prompts.items():
        ref = _oracle(pj, prompt, max_tokens=6)
        assert done[sid] == ref, (sid, done[sid], ref)
        assert streamed[sid] == list(enumerate(ref)), sid


@pytest.mark.parametrize("paged", [True, False])
def test_parity_paged_prefix_hits_and_slot_cache(params, paged):
    """Paged (with trie-matched admissions that skip the shared prefill)
    and slot caches are both token-identical to the JAX oracle; the paged
    cache leaks no block reference."""
    pj, pt = params
    rng = np.random.default_rng(5)
    system = rng.integers(1, 61, size=8).tolist()
    prompts = {"lead": system + [3, 5], "follow": system + [7, 11, 13],
               "cold": rng.integers(1, 61, size=6).tolist()}
    jobs = [(sid, p, {}) for sid, p in prompts.items()]
    done, _, stats, eng = _run_sessions(
        pt, D.DecodeSpec(_cfg(), slots=1, max_tokens=6, paged=paged,
                         block_size=4), jobs)
    for sid, p in prompts.items():
        assert done[sid] == _oracle(pj, p, max_tokens=6), sid
    assert stats["paged"] is paged
    if paged:
        assert stats["prefix_hits"] >= 1 and stats["extends"] >= 1
        assert stats["prefix_tokens_saved"] >= 8
        assert eng._cache.occupancy == 0
        assert eng._cache.leaked_blocks() == []


def test_parity_seeded_sampling_replay_token_identical(params):
    _, pt = params
    prompt = [2, 3, 5, 7, 11]
    sp = sampling.make(temperature=0.8, top_k=12, seed=99)
    spec = dict(slots=2, max_tokens=8, block_size=4)
    first, _, _, _ = _run_sessions(pt, D.DecodeSpec(_cfg(), **spec),
                                   [("r1", prompt, {"sampling": sp})])
    replay, _, _, _ = _run_sessions(pt, D.DecodeSpec(_cfg(), **spec),
                                    [("r2", prompt, {"sampling": sp})])
    assert first["r1"] == replay["r2"]
    other, _, _, _ = _run_sessions(
        pt, D.DecodeSpec(_cfg(), **spec),
        [("r3", prompt, {"sampling": sampling.make(
            temperature=0.8, top_k=12, seed=100)})])
    assert other["r3"] != first["r1"]


def test_chip_smoke_fails_without_cuda_and_alone():
    """chip_smoke.py exits non-zero and prints no ok line where there is
    no CUDA device, and in a directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    import shutil
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), d)
        alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=d,
                               env=env, capture_output=True, text=True,
                               timeout=60)
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout
