"""PyTorch port, online decode serving on the CPU: a JAX-made transformer
export served by the port's 2-replica pool (``serving.Server`` over
``ReplicaPool``, each replica a ``DecodeEngine`` in an engine executor)
held against the JAX package:

- greedy tokens equal JAX ``greedy_decode_reference`` exactly, through
  ``Server.generate`` and through ``POST /v1/generate``;
- seeded sampled streams equal the JAX ``DecodeEngine``'s for the same
  seed, token for token;
- ``PendingSession``'s ledger behaves as the JAX package's
  (index-keyed, first arrival wins, resolved once);
- a new checkpoint in ``ckpt_dir`` reaches the decode engines
  (``DecodeEngine.set_params``), and the next session gives the new
  params' greedy tokens;
- a replica SIGKILLed mid-decode loses no session and duplicates no
  token (the port's version of tests/test_decode.py's SIGKILL test);
- a replica without a CUDA device that was not asked for the CPU fails
  the pool's start, and never serves on the CPU instead.

Every wait is a hang guard (``HANG`` seconds) on a condition.  Tokens
are compared exactly; no tolerance applies.  The test config is the
JAX example's (dim 64, 2 layers, 4 heads, max_seq 64, float32).  The
JAX oracle runs eagerly and compiles each op once per sequence length,
so the prompts it checks share one length (``PLEN``) and its answers
are cached by prompt.
"""

import functools
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch import serving  # noqa: E402
from tensorflowonspark_tpu_torch.models import transformer as TT  # noqa: E402
from tensorflowonspark_tpu_torch.serving import server as S  # noqa: E402
from tensorflowonspark_tpu_torch.serving.decode import (  # noqa: E402
    scheduler as D,
)
from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

HANG = 120  # seconds: the bound of every wait
KW = dict(vocab_size=257, dim=64, n_layers=2, n_heads=4, max_seq=64,
          dtype="float32")
ENV = {"OMP_NUM_THREADS": "1"}
PLEN = 20      # the length of every prompt the JAX oracle checks
MAX_TOKENS = 8


def _jax_params(seed):
    import jax

    from tensorflowonspark_tpu.models import transformer as JT

    pj = JT.init(jax.random.PRNGKey(seed), JT.Config(**KW))
    return jax.tree_util.tree_map(np.asarray, pj)


_ORACLE = {}


def _oracle(params, prompt, max_tokens=MAX_TOKENS):
    """JAX ``greedy_decode_reference`` with ``mha_reference`` attention,
    cached by (params, prompt, max_tokens)."""
    from tensorflowonspark_tpu import ops as jops
    from tensorflowonspark_tpu.models import transformer as JT

    key = (id(params), tuple(prompt), max_tokens)
    if key not in _ORACLE:
        _ORACLE[key] = JT.greedy_decode_reference(
            params, prompt, JT.Config(**KW, attn_impl="reference"),
            max_tokens=max_tokens,
            attn_fn=functools.partial(jops.mha_reference, causal=True))
    return _ORACLE[key]


def _spec(**kw):
    return D.DecodeSpec(TT.Config(**KW), slots=4, max_tokens=16, **kw)


def _wait(cond, what):
    deadline = time.monotonic() + HANG
    while not cond():
        assert time.monotonic() < deadline, f"hang guard: {what}"
        time.sleep(0.02)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A JAX-made export: JAX ``init`` and JAX ``export_model``."""
    from tensorflowonspark_tpu.utils import checkpoint as jckpt

    params = _jax_params(0)
    d = str(tmp_path_factory.mktemp("lm") / "export")
    jckpt.export_model(d, params, metadata={})
    return d, params


@pytest.fixture(scope="module")
def srv(exported):
    export_dir, _ = exported
    spec = serving.ModelSpec(export_dir=export_dir, decode=_spec(),
                             device="cpu")
    s = serving.Server(spec, num_replicas=2, env=ENV,
                       request_timeout=HANG).start(timeout=HANG)
    yield s
    s.stop()


def _prompts(n, seed, length=None):
    """``n`` seeded prompts, of ``length`` tokens each, else of 3-39."""
    rng = np.random.default_rng(seed)
    sizes = ([length] * n if length else rng.integers(3, 40, size=n))
    return [rng.integers(1, KW["vocab_size"], size=int(k)).tolist()
            for k in sizes]


def test_greedy_tokens_equal_jax_reference_through_generate(srv, exported):
    _, params = exported
    prompts = _prompts(4, 0, PLEN)
    results = [None] * len(prompts)

    def one(i):
        results[i] = srv.generate(prompts[i], max_tokens=MAX_TOKENS,
                                  timeout=HANG)

    ts = [threading.Thread(target=one, args=(i,))
          for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(HANG)
        assert not t.is_alive(), "hang guard: a session thread"
    for p, out in zip(prompts, results):
        assert out["tokens"] == _oracle(params, p)
        assert out["ttft_ms"] is not None
        assert len(out["token_ms"]) == MAX_TOKENS - 1
    # both replicas served (least-loaded dispatch)
    assert sorted({out["replica"] for out in results}) == [0, 1]
    dec = srv.summary()["decode"]
    assert dec["completed"] >= 4 and dec["errors"] == 0


def test_http_generate_routes_and_tokens(srv, exported):
    _, params = exported
    httpd = S.serve_http(srv, port=0, block=False)
    try:
        host, port = httpd.server_address
        base = f"http://{host}:{port}"

        def post(body):
            req = urllib.request.Request(
                base + "/v1/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=HANG) as r:
                return r.status, json.loads(r.read())

        prompt = _prompts(1, 1, PLEN)[0]
        code, body = post({"prompt": prompt, "max_tokens": MAX_TOKENS})
        assert code == 200
        assert body["tokens"] == _oracle(params, prompt)
        # the same session in process gives the same tokens
        assert srv.generate(prompt, max_tokens=MAX_TOKENS)["tokens"] \
            == body["tokens"]
        for bad in ({"prompt": []}, {"prompt": "x"},
                    {"prompt": list(range(1, KW["max_seq"] + 1))},
                    {"prompt": [1, 2], "temperature": -1.0}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(bad)
            assert ei.value.code == 400, bad
        with urllib.request.urlopen(base + "/healthz", timeout=HANG) as r:
            assert json.loads(r.read())["replicas"] == [0, 1]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope", timeout=HANG)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()


def test_seeded_sampling_equals_jax_decode_engine(srv, exported):
    """The same seed draws the same stream in the port's pool as in the
    JAX package's ``DecodeEngine`` on the same params."""
    from tensorflowonspark_tpu.models import transformer as JT
    from tensorflowonspark_tpu.serving.decode import sampling as jsampling
    from tensorflowonspark_tpu.serving.decode import scheduler as JD

    _, params = exported
    prompt = _prompts(1, 2)[0]
    kw = dict(temperature=0.8, top_k=40, top_p=0.95, seed=1234)
    done = threading.Event()
    got = {}

    def emit(kind, sid, *rest):
        if kind == "done":
            got["tokens"] = [int(t) for t in rest[0]]
            done.set()
        elif kind == "error":
            got["error"] = rest[0]
            done.set()

    jeng = JD.DecodeEngine(params, JD.DecodeSpec(
        JT.Config(**KW, attn_impl="reference"), slots=4, max_tokens=16),
        emit).start(timeout=HANG)
    try:
        jeng.submit("j", prompt, max_tokens=14,
                    sampling=jsampling.make(**kw))
        assert done.wait(HANG), "hang guard: JAX engine"
    finally:
        jeng.stop()
    assert "error" not in got, got
    out = srv.generate(prompt, max_tokens=14, **kw)
    assert out["tokens"] == got["tokens"]
    again = srv.generate(prompt, max_tokens=14, **kw)
    assert again["tokens"] == out["tokens"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_pending_session_ledger_matches_jax(pkg):
    """Index-keyed, first arrival wins, resolved once: the same call
    sequence (a replay after a failover included) gives the same state
    in both packages."""
    if pkg == "jax":
        from tensorflowonspark_tpu.serving.decode import scheduler as mod
    else:
        mod = D
    s = mod.PendingSession(7, [1, 2, 3], max_tokens=4, eos_id=None,
                           sampling={"seed": 3}, trace="t")
    for i, tok in ((0, 11), (1, 12)):
        s._token(i, tok)
    # a replay re-streams from index 0 with other values: ignored
    for i, tok in ((0, 99), (1, 98), (2, 13), (3, 14)):
        s._token(i, tok)
    assert s.tokens_so_far() == [11, 12, 13, 14]
    assert not s.done()
    s._set([11, 12, 13, 14], {"replica": 1})
    s._set([0, 0, 0, 0], {"replica": 0})     # a duplicate gen_done
    s._fail(RuntimeError("late"))            # and a late error
    out = s.result(timeout=1)
    assert out["tokens"] == [11, 12, 13, 14] and out["replica"] == 1
    assert len(out["token_ms"]) == 3 and out["ttft_ms"] is not None
    f = mod.PendingSession(8, [1], max_tokens=2, eos_id=None)
    f._fail(RuntimeError("boom"))
    f._set([1, 2], {})
    with pytest.raises(RuntimeError, match="boom"):
        f.result(timeout=1)
    with pytest.raises(TimeoutError):
        mod.PendingSession(9, [1], 2, None).result(timeout=0.01)


def test_reload_reaches_the_decode_engines(tmp_path, monkeypatch):
    """A step-2 checkpoint of other params in ``ckpt_dir``: both replicas
    report version 2 and the next session gives the step-2 params'
    greedy tokens, the same prompt's step-1 tokens before.  With 8-token
    blocks the prompt has two whole blocks, which the second session of
    each pair maps: the resident prefix is dropped with the old params."""
    monkeypatch.setenv("TFOS_SERVE_RELOAD_SECS", "0.2")
    ckpt_dir = str(tmp_path / "ckpt")
    p1, p2 = _jax_params(1), _jax_params(2)
    ckpt.save_checkpoint(ckpt_dir, p1, step=1)
    spec = serving.ModelSpec(ckpt_dir=ckpt_dir, decode=_spec(block_size=8),
                             device="cpu")
    prompt = _prompts(1, 3, PLEN)[0]
    with serving.Server(spec, num_replicas=2, env=ENV,
                        request_timeout=HANG) as srv:
        assert srv.pool.versions() == {0: 1, 1: 1}
        before = [srv.generate(prompt, max_tokens=MAX_TOKENS)["tokens"]
                  for _ in range(2)]
        assert before == [_oracle(p1, prompt)] * 2
        ckpt.save_checkpoint(ckpt_dir, p2, step=2)
        _wait(lambda: srv.pool.versions() == {0: 2, 1: 2}, "reload")
        after = [srv.generate(prompt, max_tokens=MAX_TOKENS)["tokens"]
                 for _ in range(2)]
        assert after == [_oracle(p2, prompt)] * 2
        reps = srv.summary(include_replicas=True)["replica_stats"]
        assert sum(r["decode"]["prefix_hits"] for r in reps.values()) >= 2
        assert sorted(r["decode"]["reloads"] for r in reps.values()) \
            == [1, 1]
        assert all(r["version"] == 2 for r in reps.values())


def _generate_all(srv, prompts, max_tokens):
    """Every prompt's session at once; ``({i: result}, {i: error})``."""
    results, errors = {}, {}

    def one(i):
        try:
            results[i] = srv.generate(prompts[i], max_tokens=max_tokens,
                                      timeout=HANG)
        except Exception as e:  # noqa: BLE001 - asserted by callers
            errors[i] = e

    ts = [threading.Thread(target=one, args=(i,))
          for i in range(len(prompts))]
    for t in ts:
        t.start()
    return ts, results, errors


def test_sigkill_mid_decode_zero_drop_zero_dup(srv, exported):
    """Sessions in flight on a replica that is SIGKILLed re-prefill on
    the survivor; every session returns exactly the tokens the same
    prompts got without the kill, each index once, and the engine
    respawns the replica, which serves again."""
    _, params = exported
    prompts = _prompts(8, 4)
    ts, want, errors = _generate_all(srv, prompts, 16)
    for t in ts:
        t.join(HANG)
        assert not t.is_alive(), "hang guard: a session thread"
    assert not errors, errors
    respawns = srv.pool.respawns_observed
    victim = 0
    table = srv.pool._table

    def victim_streaming():
        for key in table.owned_by({victim}):
            entry = table.get(key)
            if entry is not None and entry["session"].tokens_so_far():
                return True
        return False

    ts, results, errors = _generate_all(srv, prompts, 16)
    _wait(victim_streaming, "a session streaming on the victim")
    os.kill(srv.pool.replica_pids()[victim], 9)
    for t in ts:
        t.join(HANG)
        assert not t.is_alive(), "hang guard: a session thread"
    assert not errors, errors
    for i in range(len(prompts)):
        assert results[i]["tokens"] == want[i]["tokens"], i
        # one gap a token: no index arrived twice or went missing
        assert len(results[i]["token_ms"]) == 15, i
    _wait(lambda: srv.pool.respawns_observed > respawns
          and srv.pool.live_replicas() == [0, 1], "respawn")
    # the respawned replica serves: concurrent sessions spread over both
    p = _prompts(1, 0, PLEN)[0]
    ts, outs, errors = _generate_all(srv, [p] * 4, MAX_TOKENS)
    for t in ts:
        t.join(HANG)
        assert not t.is_alive(), "hang guard: a session thread"
    assert not errors, errors
    assert {o["replica"] for o in outs.values()} == {0, 1}
    assert all(o["tokens"] == _oracle(params, p) for o in outs.values())


def test_no_cuda_replica_fails_the_pool_start(exported, monkeypatch):
    """``device=None`` means the card: with none present each replica
    reports an init error and ``start()`` raises; it never serves on
    the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    export_dir, _ = exported
    spec = serving.ModelSpec(export_dir=export_dir, decode=_spec())
    s = serving.Server(spec, num_replicas=1, env=ENV)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.start(timeout=HANG)
    s.stop()
    assert s.pool.live_replicas() == []


def test_jit_and_cut_pool_features_raise():
    with pytest.raises(NotImplementedError, match="item 26"):
        serving.ModelSpec(predict="m:f", jit=True)
    # the elastic pool, the fabric and canary routing are ported: each
    # Server mounts its pool, as the JAX Server does, and a canary on a
    # pool with no live replica is the JAX package's ValueError
    from tensorflowonspark_tpu_torch.serving import elastic, fabric

    spec = serving.ModelSpec(predict="m:f")
    for kw, cls in ((dict(elastic=True), elastic.ElasticReplicaPool),
                    (dict(fabric=True), fabric.FabricRouter),
                    (dict(logical_replicas=2), elastic.ElasticReplicaPool)):
        assert type(serving.Server(spec, **kw).pool) is cls
    pool = serving.ReplicaPool(spec)
    with pytest.raises(ValueError, match="not all live"):
        pool.set_canary([0], 2, 10)
    # speculative decoding is ported: a draft with its config is a valid
    # spec, one without it the JAX package's ValueError
    assert D.DecodeSpec(TT.Config(**KW), draft_params={},
                        draft_cfg=TT.Config(**KW)).speculative
    with pytest.raises(ValueError, match="BOTH"):
        D.DecodeSpec(TT.Config(**KW), draft_params={}, draft_cfg=None)
