"""PyTorch port, speculative decoding (``DecodeSpec(draft_params=,
draft_cfg=, spec_window=)``) on the CPU, against the JAX package's
speculative ``DecodeEngine`` on the same params:

- the port's speculative engine gives the JAX engine's tokens and its
  ``spec_proposed``/``spec_accepted`` counts, greedy and seeded
  sampling (the sizes of ``tests/test_decode.py``'s speculative test:
  a dim-32, 2-layer target, a dim-16, 1-layer draft, window 3);
- speculative output equals the port's plain output token for token;
- a perfect draft (the target itself) has every proposal accepted;
- the JAX package's three ValueErrors and the ``TFOS_DECODE_SPEC_WINDOW``
  default; ``stats()``'s speculative keys;
- a speculative ``generate`` through ``Server`` with one replica (the
  draft rides the replica payload) equals the plain engine's tokens;
- ``set_params`` swaps the target and leaves the draft as it was.

The batch composition is pinned, so that no timing decides which
sessions share an iteration: every session is queued before the engine
starts (one admission takes them all), and ``slots`` is at least the
number of sessions.  Tokens are compared exactly.

The JAX engine's speculative counts depend on timing: its draft loop
(``tensorflowonspark_tpu/serving/decode/scheduler.py:644-648``) passes
``dcache.lengths``, a numpy array, to the asynchronously dispatched
draft step and increments it before waiting for the step, and on the
CPU JAX may read that array in place, so a step can see the advanced
cursors and write its K/V one position late (a perfect draft then
accepted 5 of 14 proposals in one run and 8 of 8 in the next).  The
comparison gives the JAX engine's jitted steps copies of their numpy
arguments (``jax_steps_copy_numpy_inputs``), which is the engine's
intended behaviour; the tokens are the same either way.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402

from tensorflowonspark_tpu.models import transformer as JT  # noqa: E402
from tensorflowonspark_tpu.serving.decode import (  # noqa: E402
    sampling as jsampling,
    scheduler as JD,
)
from tensorflowonspark_tpu_torch import serving  # noqa: E402
from tensorflowonspark_tpu_torch.models import transformer as TT  # noqa: E402
from tensorflowonspark_tpu_torch.serving.decode import (  # noqa: E402
    sampling,
    scheduler as D,
)
from tensorflowonspark_tpu_torch.utils import metrics_registry  # noqa: E402

HANG = 240
KW = dict(vocab_size=61, dim=32, n_layers=2, n_heads=2, max_seq=32,
          dtype="float32")
DKW = dict(KW, dim=16, n_layers=1)
WINDOW = 3
MAX_TOKENS = 10
SP = dict(temperature=0.9, top_k=16, seed=7)


def _jobs(mod, jax_test=False):
    """``tests/test_decode.py``'s two sessions (one greedy, one seeded),
    or four: two greedy, two seeded."""
    sp = mod.make(**SP)
    jobs = [("g1", [3, 5, 7, 9, 11], {}),
            ("s1", [4, 6, 8, 10], {"sampling": sp})]
    if jax_test:
        return jobs
    sp2 = mod.make(temperature=0.7, top_p=0.9, seed=11)
    return jobs + [("g2", [2, 4, 6, 8, 10, 12, 14, 16, 18], {}),
                   ("s2", [1, 3, 5, 7, 9, 11, 13], {"sampling": sp2})]


@pytest.fixture(scope="module")
def nets():
    """(JAX target, JAX draft) params as numpy trees, and the port's."""
    pj = jax.tree_util.tree_map(
        np.asarray, JT.init(jax.random.PRNGKey(0), JT.Config(**KW)))
    dj = jax.tree_util.tree_map(
        np.asarray, JT.init(jax.random.PRNGKey(7), JT.Config(**DKW)))
    return (pj, dj, TT.params_from_jax(pj, _cfg(), device="cpu"),
            TT.params_from_jax(dj, _cfg(DKW), device="cpu"))


def _cfg(kw=KW):
    return TT.Config(**kw, attn_impl="flash")


def _jcfg(kw=KW):
    return JT.Config(**kw, attn_impl="reference")


def _drive(make_engine, jobs):
    """Queue every job, then start the engine (one admission takes them
    all); returns ({sid: tokens}, stats, engine)."""
    done, errors = {}, {}
    lock = threading.Lock()

    def emit(kind, sid, *rest):
        with lock:
            if kind == "done":
                done[sid] = list(rest[0])
            elif kind == "error":
                errors[sid] = rest[0]

    eng = make_engine(emit)
    for sid, prompt, kw in jobs:
        eng.submit(sid, prompt, **kw)
    eng.start(timeout=HANG)
    try:
        deadline = time.monotonic() + HANG
        while len(done) + len(errors) < len(jobs):
            assert time.monotonic() < deadline, "hang guard: sessions"
            time.sleep(0.01)
    finally:
        eng.stop()
    # after stop: the last iteration has finished counting
    stats = eng.stats()
    assert not errors, errors
    return done, stats, eng


def _port(params, spec, jobs=None):
    return _drive(lambda emit: D.DecodeEngine(params, spec, emit,
                                              device="cpu"),
                  jobs or _jobs(sampling))


def _spec(draft=None, dkw=DKW, **kw):
    kw = {"slots": 4, "max_tokens": MAX_TOKENS, "block_size": 4, **kw}
    if draft is not None:
        kw.update(draft_params=draft, draft_cfg=_cfg(dkw),
                  spec_window=WINDOW)
    return D.DecodeSpec(_cfg(), **kw)


@pytest.fixture
def jax_steps_copy_numpy_inputs(monkeypatch):
    """``jax.jit`` functions made while this is in force take copies of
    their numpy arguments (see the module docstring)."""
    real = jax.jit

    def jit(fn, *a, **kw):
        compiled = real(fn, *a, **kw)

        def call(*args):
            return compiled(*(np.array(x) if isinstance(x, np.ndarray)
                              else x for x in args))

        return call

    monkeypatch.setattr(jax, "jit", jit)


@pytest.mark.parametrize("draft", ["narrow", "perfect"])
def test_speculative_engine_matches_jax_engine(nets, draft,
                                               jax_steps_copy_numpy_inputs):
    """``tests/test_decode.py``'s speculative sessions (slots 2, 7
    tokens, window 3) through both engines, with the narrow draft and
    with the target as its own draft: the same tokens, iterations and
    proposal counts."""
    pj, dj, pt, dt = nets
    if draft == "perfect":
        dj, dt, dkw = pj, pt, KW
    else:
        dkw = DKW
    jspec = JD.DecodeSpec(_jcfg(), slots=2, max_tokens=7, block_size=4,
                          draft_params=dj, draft_cfg=_jcfg(dkw),
                          spec_window=WINDOW)
    ref, jstats, _ = _drive(lambda emit: JD.DecodeEngine(pj, jspec, emit),
                            _jobs(jsampling, jax_test=True))
    got, stats, _ = _port(pt, _spec(dt, dkw=dkw, slots=2, max_tokens=7),
                          _jobs(sampling, jax_test=True))
    assert got == ref
    for key in ("spec_proposed", "spec_accepted", "iterations"):
        assert stats[key] == jstats[key], (key, stats, jstats)
    assert stats["spec_proposed"] > 0


def test_speculative_equals_plain(nets):
    _, _, pt, dt = nets
    plain, pstats, _ = _port(pt, _spec())
    specd, stats, _ = _port(pt, _spec(dt))
    assert specd == plain
    assert "spec_proposed" not in pstats
    # fewer verify iterations than tokens when any proposal lands
    assert stats["iterations"] <= pstats["iterations"]


def test_perfect_draft_accepts_every_proposal(nets):
    _, _, pt, _ = nets
    plain, pstats, _ = _port(pt, _spec())
    perfect, stats, _ = _port(pt, _spec(pt, dkw=KW))
    assert perfect == plain
    assert stats["spec_accepted"] == stats["spec_proposed"] > 0
    assert stats["spec_accept_rate"] == 1.0
    assert stats["iterations"] < pstats["iterations"]


@pytest.mark.parametrize("kw,match", [
    (dict(draft_params={}, draft_cfg=None), "BOTH"),
    (dict(draft_params=None, draft_cfg="cfg"), "BOTH"),
    (dict(draft_params={}, draft_cfg="cfg", spec_window=1), "spec_window"),
    (dict(draft_params={}, draft_cfg="cfg", paged=False), "paged"),
])
def test_spec_value_errors_match_jax(kw, match):
    if kw.get("draft_cfg") == "cfg":
        kw = dict(kw, draft_cfg=_cfg(DKW))
    with pytest.raises(ValueError, match=match):
        D.DecodeSpec(_cfg(), **kw)
    jkw = dict(kw)
    if jkw.get("draft_cfg") is not None:
        jkw["draft_cfg"] = _jcfg(DKW)
    with pytest.raises(ValueError, match=match):
        JD.DecodeSpec(_jcfg(), **jkw)


def test_spec_window_env_default(monkeypatch):
    monkeypatch.delenv(D.SPEC_WINDOW_ENV, raising=False)
    assert D.DecodeSpec(_cfg()).spec_window == 4 \
        == JD.DecodeSpec(_jcfg()).spec_window
    monkeypatch.setenv(D.SPEC_WINDOW_ENV, "6")
    spec = D.DecodeSpec(_cfg(), draft_params={}, draft_cfg=_cfg(DKW))
    assert spec.spec_window == 6 and spec.speculative
    assert not D.DecodeSpec(_cfg()).speculative
    monkeypatch.setenv(D.SPEC_WINDOW_ENV, "1")
    with pytest.raises(ValueError, match="spec_window"):
        D.DecodeSpec(_cfg())


def test_stats_keys_and_gauge(nets, monkeypatch):
    _, _, pt, dt = nets
    gauges = {}
    monkeypatch.setattr(metrics_registry, "set_gauge",
                        lambda name, v, **kw: gauges.__setitem__(name, v))
    _, stats, _ = _port(pt, _spec(dt))
    for key in ("spec_proposed", "spec_accepted", "spec_accept_rate"):
        assert key in stats
    assert stats["spec_accept_rate"] == round(
        stats["spec_accepted"] / stats["spec_proposed"], 4)
    assert gauges["tfos_decode_spec_accept"] == stats["spec_accept_rate"]
    assert "tfos_decode_spec_accept" in metrics_registry.CATALOG


def test_speculative_generate_through_server(nets):
    """The draft rides the one replica's payload (as the JAX tree a user
    would pass); the server's tokens equal the plain engine's."""
    pj, dj, pt, _ = nets
    jobs = _jobs(sampling)
    plain, _, _ = _port(pt, _spec(), jobs)
    spec = serving.ModelSpec(params=pj, decode=_spec(dj), device="cpu")
    with serving.Server(spec, num_replicas=1, env={"OMP_NUM_THREADS": "1"},
                        request_timeout=HANG).start(timeout=HANG) as srv:
        for sid, prompt, kw in jobs:
            sp = kw.get("sampling") or {}
            out = srv.generate(prompt, max_tokens=MAX_TOKENS, timeout=HANG,
                               **sp)
            assert out["tokens"] == plain[sid], sid
        st = srv.pool.stats()
    decode = [r["decode"] for r in st.values() if "decode" in r]
    assert decode and decode[0]["spec_proposed"] > 0


def test_set_params_swaps_the_target_only(nets):
    """After a reload the engine's draft is the one it started with, and
    the sessions give the new target's plain tokens."""
    _, _, pt, dt = nets
    pt2 = TT.init(_cfg(), torch.Generator().manual_seed(3), device="cpu")
    plain2, _, _ = _port(pt2, _spec())
    jobs = _jobs(sampling)
    done, errors = {}, {}

    def emit(kind, sid, *rest):
        if kind == "done":
            done[sid] = list(rest[0])
        elif kind == "error":
            errors[sid] = rest[0]

    eng = D.DecodeEngine(pt, _spec(dt), emit, device="cpu").start(HANG)
    try:
        draft = {k: v.clone() for k, v in eng._draft["layers"].items()}
        eng.set_params(pt2)
        deadline = time.monotonic() + HANG
        while eng.reloads == 0:
            assert time.monotonic() < deadline, "hang guard: reload"
            time.sleep(0.01)
        for sid, prompt, kw in jobs:
            eng.submit(sid, prompt, **kw)
        while len(done) + len(errors) < len(jobs):
            assert time.monotonic() < deadline, "hang guard: sessions"
            time.sleep(0.01)
        for k, v in eng._draft["layers"].items():
            torch.testing.assert_close(v, draft[k], rtol=0, atol=0)
        assert eng._draft["embed"].data_ptr() != eng._params[
            "embed"].data_ptr()
    finally:
        eng.stop()
    assert not errors, errors
    assert done == plain2
