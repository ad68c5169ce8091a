"""PyTorch port, the serving fabric on the CPU, held against the JAX
package (its ``tests/test_fabric.py``, test for test):

- ``Ring.lookup`` gives the JAX ring's endpoint for every key, on the
  same endpoints and after a membership change; the ``AffinityMap`` is
  a bounded LRU;
- the ``ServeAutoscaler`` kernel publishes the JAX kernel's plans over
  the same signal sequences (injected mode), and reads the same env
  knobs;
- the load generator's route ids equal the JAX generator's;
- ``Server(fabric=True)`` round-trips predicts across 2 hosts x 2
  workers, and ``/statusz``'s ``pods`` and ``tfos-top-torch --pods``
  show both hosts; the two fabric fault sites fire;
- decode through the fabric gives the greedy tokens of the JAX
  ``greedy_decode_reference`` on the same params (a JAX-made export)
  and the local pool's seeded stream; a route id goes miss, then hit,
  and the second turn maps its prefix from the worker's trie;
- the elastic mirror's acceptance follows the hot-reload watermark;
- a SIGKILL of the host an affinity-bound session targets drops and
  duplicates nothing, and every session equals the JAX oracle;
- the supervised autoscaler scales a host up under queueing.

Tokens compare exactly; predicts with ``pytest.approx``'s default (1e-6
relative).  The JAX slow-lane tests run here in tier 1 at the small
size, each under a bound of :data:`BOUND_S` seconds of its own.
Predicts are module-level functions of this file (the executors import
it), so it imports no JAX at the top.
"""

import contextlib
import functools
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch.serving import replicas as R  # noqa: E402
from tensorflowonspark_tpu_torch.serving import server as S  # noqa: E402
from tensorflowonspark_tpu_torch.serving.fabric import (  # noqa: E402
    affinity as FA,
)
from tensorflowonspark_tpu_torch.serving.fabric import (  # noqa: E402
    autoscale as FS,
)
from tensorflowonspark_tpu_torch.serving.fabric import (  # noqa: E402
    router as FR,
)
from tensorflowonspark_tpu_torch.utils import faults  # noqa: E402

ENV = {"OMP_NUM_THREADS": "1"}
HANG = 90      # seconds: the bound of every wait
BOUND_S = 90   # seconds: the bound of each live-fabric test
KW = dict(vocab_size=257, dim=64, n_layers=2, n_heads=4, max_seq=64,
          dtype="float32")


def _double_predict(params, inputs, device=None):
    return {"y": np.asarray(inputs["x"]) * params["scale"]}


def _slow_predict(params, inputs, device=None):
    time.sleep(0.05)
    return {"y": np.asarray(inputs["x"]) * 1.0}


@contextlib.contextmanager
def _bounded(seconds=BOUND_S):
    t0 = time.monotonic()
    yield
    took = time.monotonic() - t0
    assert took < seconds, f"took {took:.1f} s, over the {seconds} s bound"


_ORACLE = {}


def _oracle(params, prompt, max_tokens):
    """JAX ``greedy_decode_reference``, cached by prompt."""
    from tensorflowonspark_tpu import ops as jops
    from tensorflowonspark_tpu.models import transformer as JT

    key = (tuple(prompt), max_tokens)
    if key not in _ORACLE:
        _ORACLE[key] = JT.greedy_decode_reference(
            params, prompt, JT.Config(**KW, attn_impl="reference"),
            max_tokens=max_tokens,
            attn_fn=functools.partial(jops.mha_reference, causal=True))
    return _ORACLE[key]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A JAX-made export (JAX ``init`` and ``export_model``)."""
    import jax

    from tensorflowonspark_tpu.models import transformer as JT
    from tensorflowonspark_tpu.utils import checkpoint as jckpt

    params = jax.tree_util.tree_map(
        np.asarray, JT.init(jax.random.PRNGKey(0), JT.Config(**KW)))
    d = str(tmp_path_factory.mktemp("fabric") / "export")
    jckpt.export_model(d, params, metadata={})
    return d, params


def _decode_spec(export_dir, **kw):
    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.models import transformer as TT

    kw.setdefault("slots", 4)
    kw.setdefault("max_tokens", 24)
    return R.ModelSpec(export_dir=export_dir, device="cpu",
                       decode=serving.DecodeSpec(TT.Config(**KW), **kw))


# -- the ring and the affinity map ----------------------------------------------

def test_ring_deterministic_and_balanced():
    from tensorflowonspark_tpu.serving.fabric import affinity as JFA

    eps = [(h, r) for h in range(3) for r in range(2)]
    ring = FA.Ring(eps)
    keys = [f"route-{i}" for i in range(600)]
    picks = [ring.lookup(k) for k in keys]
    assert picks == [FA.Ring(eps).lookup(k) for k in keys]
    assert picks == [JFA.Ring(eps).lookup(k) for k in keys]
    counts = {ep: picks.count(ep) for ep in eps}
    assert set(counts) == set(eps)
    assert min(counts.values()) > 20 and max(counts.values()) < 300
    assert FA.DEFAULT_VNODES == JFA.DEFAULT_VNODES


def test_ring_consistency_on_membership_change():
    from tensorflowonspark_tpu.serving.fabric import affinity as JFA

    before = FA.Ring([(h, 0) for h in range(4)])
    after = FA.Ring([(h, 0) for h in range(4) if h != 2])
    jafter = JFA.Ring([(h, 0) for h in range(4) if h != 2])
    keys = [f"s{i}" for i in range(400)]
    moved = sum(1 for k in keys
                if before.lookup(k) != (2, 0)
                and before.lookup(k) != after.lookup(k))
    assert moved == 0  # only the removed endpoint's keys move
    assert [after.lookup(k) for k in keys] == [jafter.lookup(k)
                                               for k in keys]
    with pytest.raises(ValueError):
        FA.Ring([])


def test_affinity_map_is_a_bounded_lru():
    m = FA.AffinityMap(capacity=3)
    for i in range(3):
        m.bind(f"s{i}", (i, 0))
    assert m.get("s0") == (0, 0)      # refreshes recency
    m.bind("s3", (3, 0))              # evicts s1
    assert m.get("s1") is None
    assert m.get("s0") == (0, 0) and m.get("s3") == (3, 0)
    assert len(m) == 3
    assert m.pop("s3") == (3, 0) and m.get("s3") is None


# -- the autoscaler's kernel (injected mode), against the JAX kernel ---------------

def _scalers(sig, **kw):
    """The port's and the JAX kernel over one signal, with their plans."""
    from tensorflowonspark_tpu.serving.fabric import autoscale as JFS

    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("high", 2.0)
    kw.setdefault("low", 0.5)
    kw.setdefault("cooldown", 10.0)
    out = []
    for mod in (FS, JFS):
        plans = []
        out.append((mod.ServeAutoscaler(read_signal=lambda: sig,
                                        apply_plan=plans.append, **kw),
                    plans))
    return out


def _steps(scalers, nows):
    return [[sc.step(now=t) for t in nows] + [plans]
            for sc, plans in scalers]


def test_autoscaler_scales_up_emptiest_host_on_queueing():
    sig = {0: {"workers": 2, "depth": 9}, 1: {"workers": 1, "depth": 4}}
    (sc, plans), jax_ = _scalers(sig)
    assert sc.step(now=0.0) == "up"
    assert plans == [{0: 2, 1: 2}]  # spread before stacking
    assert sc.scale_ups == 1
    assert sc.step(now=5.0) is None  # cooldown
    assert sc.step(now=11.0) == "up"
    assert plans[-1] == {0: 2, 1: 2}
    port, jax_ = _steps(_scalers(sig), [0.0, 5.0, 11.0, 12.0, 25.0])
    assert port == jax_


def test_autoscaler_scales_down_fullest_host_and_clamps():
    sig = {0: {"workers": 3, "depth": 0}, 1: {"workers": 1, "depth": 0}}
    (sc, plans), _ = _scalers(sig)
    assert sc.step(now=0.0) == "down"
    assert plans == [{0: 2, 1: 1}]  # the fullest host sheds one
    for sig2 in ({0: {"workers": 1, "depth": 0}},      # at the min
                 {0: {"workers": 3, "depth": 99}},     # at the max
                 {0: {"workers": 2, "depth": 2}},      # in the band
                 None):                                # no signal
        (sc2, plans2), _ = _scalers(sig2)
        assert sc2.step(now=0.0) is None and plans2 == []
    # the JAX kernel's decisions and plans over each of these signals
    for s in (sig, {0: {"workers": 1, "depth": 0}},
              {0: {"workers": 3, "depth": 99}}, {0: {"workers": 2,
                                                     "depth": 2}},
              {0: {"workers": 4, "depth": 1}, 1: {"workers": 2,
                                                  "depth": 0}}, None):
        port, jax_ = _steps(_scalers(s, max_replicas=4),
                            [0.0, 3.0, 10.0, 20.5])
        assert port == jax_, s


def test_autoscaler_env_knobs_and_validation(monkeypatch):
    from tensorflowonspark_tpu.serving.fabric import autoscale as JFS

    monkeypatch.setenv(FS.MIN_ENV, "2")
    monkeypatch.setenv(FS.MAX_ENV, "6")
    monkeypatch.setenv(FS.HIGH_ENV, "3.5")
    monkeypatch.setenv(FS.LOW_ENV, "0.1")
    monkeypatch.setenv(FS.COOLDOWN_ENV, "1.5")
    for mod in (FS, JFS):
        sc = mod.ServeAutoscaler()
        assert (sc.min_replicas, sc.max_replicas) == (2, 6)
        assert (sc.high, sc.low, sc.cooldown) == (3.5, 0.1, 1.5)
    with pytest.raises(ValueError):
        FS.ServeAutoscaler(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        FS.ServeAutoscaler(high=1.0, low=1.0)


# -- the load generator's route ids ---------------------------------------------

def test_session_route_ids_and_affinity_aggregation():
    from tensorflowonspark_tpu.serving import decode as JD

    from tensorflowonspark_tpu_torch.serving import decode as D

    ids = D.session_route_ids(32, sessions=4, seed=7)
    assert len(ids) == 32 and set(ids) <= {f"s{k}" for k in range(4)}
    assert ids == D.session_route_ids(32, sessions=4, seed=7)
    assert ids == JD.session_route_ids(32, sessions=4, seed=7)
    seen = []

    def request_fn(i, route_id):
        seen.append((i, route_id))
        return {"tokens": 1, "affinity": "hit" if i % 4 else "miss"}

    stats = D.run_open_loop(request_fn, rate_rps=2000, n_requests=8,
                            route_fn=ids.__getitem__)
    assert sorted(i for i, _ in seen) == list(range(8))
    assert all(rid == ids[i] for i, rid in seen)
    assert stats["affinity_hits"] == 6
    assert stats["affinity_misses"] == 2
    assert stats["affinity_fallbacks"] == 0
    assert stats["affinity_hit_rate"] == pytest.approx(6 / 8)
    plain = D.run_open_loop(lambda i: None, rate_rps=2000, n_requests=3)
    assert "affinity_hit_rate" not in plain


# -- predicts across hosts ---------------------------------------------------------

def test_fabric_predict_roundtrip_and_describe():
    from tensorflowonspark_tpu_torch.obs import http as obs_http
    from tensorflowonspark_tpu_torch.obs import top as obs_top

    spec = R.ModelSpec(predict=_double_predict, params={"scale": 3.0},
                       device="cpu")
    with _bounded(), S.Server(spec, fabric=True, fabric_hosts=2,
                              replicas_per_host=2, max_batch=8,
                              max_delay_ms=5, env=ENV,
                              request_timeout=HANG) as srv:
        assert isinstance(srv.pool, FR.FabricRouter)
        c = srv.client()
        outs = [c.predict({"x": np.array([float(i)], np.float32)},
                          timeout=HANG) for i in range(6)]
        for i, out in enumerate(outs):
            assert out["y"] == pytest.approx([3.0 * i])
        assert sorted(srv.pool.live_replicas()) == [0, 1]
        desc = srv.pool.describe()
        assert desc["fabric"] and desc["live_hosts"] == 2
        assert desc["replicas"] == 4  # 2 hosts x 2 workers
        rows = FR.fabric_table()
        assert {r["host"] for r in rows} == {0, 1}
        assert all(r["alive"] and r["replicas"] == 2 for r in rows)
        statusz = obs_http.ObsServer(cluster=None, port=0,
                                     interval=999).render_statusz()
        assert {r["host"] for r in statusz["pods"]} == {0, 1}
        pane = obs_top.render_pods(statusz)
        assert "pods (serving/fabric/):" in pane
        assert pane.count("yes") == 2
        from tensorflowonspark_tpu.obs import top as jtop

        assert pane == jtop.render_pods(statusz)  # the JAX tool's pane
        st = srv.pool.stats(timeout=30)
        assert set(st) == {0, 1}
        assert all(len(v["workers"]) == 2 for v in st.values())
        assert all(v["device"] == "cpu" for v in st.values())
    assert FR.fabric_table() == []  # stop() deregisters the router


def test_fabric_dispatch_and_route_fault_sites(monkeypatch):
    spec = R.ModelSpec(predict=_double_predict, params={"scale": 2.0},
                       device="cpu")
    with _bounded(), S.Server(spec, fabric=True, fabric_hosts=1,
                              max_batch=4, max_delay_ms=5, env=ENV,
                              request_timeout=HANG) as srv:
        c = srv.client()
        monkeypatch.setenv("TFOS_FAULT_PLAN", "serve.fabric_dispatch:exc@1")
        faults._reset_for_tests()
        try:
            with pytest.raises(Exception):
                c.predict({"x": np.ones(1, np.float32)}, timeout=HANG)
            out = c.predict({"x": np.ones(1, np.float32)}, timeout=HANG)
            assert out["y"] == pytest.approx([2.0])
        finally:
            monkeypatch.delenv("TFOS_FAULT_PLAN")
            faults._reset_for_tests()
    router = FR.FabricRouter(spec, num_hosts=1)
    monkeypatch.setenv("TFOS_FAULT_PLAN", "serve.fabric_route:exc@1")
    faults._reset_for_tests()
    try:
        with pytest.raises(RuntimeError):
            router._route_session("s1")
        assert router._route_session(None) == (None, None, None)
    finally:
        monkeypatch.delenv("TFOS_FAULT_PLAN")
        faults._reset_for_tests()


# -- decode parity and session affinity ---------------------------------------------

def test_fabric_decode_parity_and_affinity(exported):
    """A session routed through the fabric gives the JAX oracle's greedy
    tokens and the local pool's seeded stream; a route id goes miss,
    then hit; the second turn (the first turn's prompt and answer, the
    same route id) is a hit on the same worker, whose prefix trie maps
    the first turn's whole blocks."""
    export_dir, params = exported
    spec = _decode_spec(export_dir, paged=True, block_size=8,
                        prefix_sharing=True)
    prompt = [2, 3, 5, 7]
    ref = _oracle(params, prompt, 6)
    with _bounded(), S.Server(spec, num_replicas=1, env=ENV,
                              request_timeout=HANG) as srv:
        local = srv.generate(prompt, max_tokens=6, timeout=HANG)
        local_seeded = srv.generate(prompt, max_tokens=6, timeout=HANG,
                                    temperature=0.9, top_k=8, seed=5)
    assert local["tokens"] == ref
    rng = np.random.default_rng(5)
    turn1 = rng.integers(0, KW["vocab_size"], size=20).tolist()
    with _bounded(), S.Server(spec, fabric=True, fabric_hosts=2,
                              replicas_per_host=2, env=ENV,
                              request_timeout=HANG) as srv:
        out1 = srv.generate(prompt, max_tokens=6, timeout=HANG,
                            route_id="alice")
        assert out1["tokens"] == ref == local["tokens"]
        assert out1["affinity"] == "miss"
        bound = srv.pool.affinity_binding("alice")
        assert bound is not None
        out2 = srv.generate(prompt, max_tokens=6, timeout=HANG,
                            route_id="alice")
        assert out2["tokens"] == ref and out2["affinity"] == "hit"
        assert srv.pool.affinity_binding("alice") == bound
        fs = srv.generate(prompt, max_tokens=6, timeout=HANG,
                          temperature=0.9, top_k=8, seed=5)
        assert fs["tokens"] == local_seeded["tokens"]
        assert "affinity" not in srv.generate(prompt, max_tokens=4,
                                              timeout=HANG)
        assert srv.pool.affinity_counts() == {"hit": 1, "miss": 1,
                                              "fallback": 0}
        # two turns of one conversation: the second prefills only the
        # tail past the first turn's whole blocks, on the same worker
        a = srv.generate(turn1, max_tokens=8, timeout=HANG, route_id="bob")
        assert a["tokens"] == _oracle(params, turn1, 8)
        h, w = srv.pool.affinity_binding("bob")
        before = srv.pool.stats(timeout=30)[h]["workers"][w]["decode"]
        turn2 = turn1 + a["tokens"]
        b = srv.generate(turn2, max_tokens=8, timeout=HANG, route_id="bob")
        assert b["affinity"] == "hit" and b["host"] == h
        assert srv.pool.affinity_binding("bob") == (h, w)
        assert b["tokens"] == _oracle(params, turn2, 8)
        after = srv.pool.stats(timeout=30)[h]["workers"][w]["decode"]
        assert after["prefix_hits"] == before["prefix_hits"] + 1
        assert after["prefix_tokens_saved"] - before[
            "prefix_tokens_saved"] >= 16


# -- the elastic mirror's watermark ---------------------------------------------------

def test_elastic_mirror_acceptance_uses_reload_watermark():
    from tensorflowonspark_tpu_torch.serving import elastic as E

    spec = R.ModelSpec(predict=_double_predict, params={"scale": 1.0},
                       device="cpu")
    pool = E.ElasticReplicaPool(spec, num_replicas=1)
    assert pool._accept_mirror(5)
    pool._mirror_version = 5
    assert not pool._accept_mirror(4)
    pool._reload_watermark = 5
    assert not pool._accept_mirror(7)
    assert pool._accept_mirror(5)
    pool.set_watermark(9)  # a promotion watermark takes precedence
    assert pool._accept_mirror(7)
    pool._mirror_version = 7
    assert not pool._accept_mirror(6)


# -- a host's SIGKILL, and the autoscaler, live ------------------------------------------

def test_fabric_host_sigkill_zero_drop_zero_dup(exported):
    """SIGKILL the host an affinity-bound session targets while sessions
    are in flight: every session returns the JAX oracle's tokens (zero
    drop, zero dup), the route stays bound, the host respawns."""
    export_dir, params = exported
    spec = _decode_spec(export_dir)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, KW["vocab_size"], size=12).tolist()
               for _ in range(6)]
    refs = [_oracle(params, p, 20) for p in prompts]  # before the bound
    with _bounded(), S.Server(spec, fabric=True, fabric_hosts=2, env=ENV,
                              request_timeout=HANG,
                              decode_queue_max=64) as srv:
        out = srv.generate([1, 2, 3], max_tokens=2, timeout=HANG,
                           route_id="victim")
        assert out["affinity"] == "miss"
        target = srv.pool.affinity_binding("victim")[0]
        results, errors = {}, {}

        def one(i, route_id=None):
            try:
                results[i] = srv.generate(prompts[i], max_tokens=20,
                                          timeout=HANG, route_id=route_id)
            except Exception as e:  # noqa: BLE001 - asserted below
                errors[i] = e

        ts = [threading.Thread(target=one, args=(i,),
                               kwargs={"route_id": "victim" if i == 0
                                       else None})
              for i in range(6)]
        for t in ts:
            t.start()
        deadline = time.monotonic() + HANG
        while srv.pool.outstanding_sessions() < 3 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        os.kill(srv.pool.host_pids()[target], 9)
        for t in ts:
            t.join()
        assert not errors, errors
        assert len(results) == 6
        for i, o in results.items():
            assert o["tokens"] == refs[i], i
        assert srv.pool.affinity_binding("victim") is not None
        # the engine respawns the executor at once: the router sees the
        # kill at the respawn's up
        deadline = time.monotonic() + HANG
        while (srv.pool.describe()["respawns"] < 1
               or len(srv.pool.live_replicas()) < 2) and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        assert len(srv.pool.live_replicas()) == 2
        assert srv.pool.describe()["respawns"] >= 1
        after = srv.generate(prompts[1], max_tokens=20, timeout=HANG,
                             route_id="victim")
        assert after["tokens"] == refs[1]


def test_fabric_autoscaler_scales_up_under_load():
    """Under sustained queueing the supervised autoscaler publishes an
    up-plan and the router actuates it: a host's workers grow."""
    from tensorflowonspark_tpu_torch.serving import batcher as B

    spec = R.ModelSpec(predict=_slow_predict, params={}, device="cpu")
    router = FR.FabricRouter(
        spec, num_hosts=2, replicas_per_host=1, env=ENV,
        request_timeout=HANG,
        autoscale={"min_replicas": 1, "max_replicas": 3, "high": 1.5,
                   "low": 0.0, "cooldown": 1.0, "tick_secs": 0.2})
    with _bounded():
        router.start(timeout=HANG)
        try:
            n = [0]

            def fire():
                n[0] += 1
                router.dispatch(B.Batch(
                    f"as-{n[0]}", [], {"x": np.ones((2, 1), np.float32)},
                    2, 0.0))

            deadline = time.monotonic() + HANG
            while router.scale_ups < 1 and time.monotonic() < deadline:
                while len(router._table) < 8:
                    fire()
                time.sleep(0.05)
            assert router.scale_ups >= 1
            assert router.describe()["scale_ups"] >= 1
            deadline = time.monotonic() + HANG
            while time.monotonic() < deadline:
                if sum(router._live_workers().values()) > 2:
                    break
                time.sleep(0.1)
            assert sum(router._live_workers().values()) > 2
            assert router.scale_times  # the directive's ack came back
        finally:
            router.stop()
