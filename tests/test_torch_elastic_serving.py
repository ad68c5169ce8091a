"""PyTorch port, the elastic serving pool on the CPU, held against the
JAX package (its ``tests/test_elastic_serving.py``, test for test):

- ``assign_slots`` gives the JAX function's shares for every logical
  capacity and live set tried;
- the in-flight table's quiesce, the compile-count contract keyed by the
  mesh shape, declared degraded admission (``set_capacity``), the boot
  gate (``await_boot``), adoption from the mirror (``adopt_predictor``)
  and ``params_blob`` (host numpy leaves, never a tensor);
- the serving chaos sites and their seeded plans (the JAX plans);
- a live 2-replica pool drains one replica and refuses its last;
- a SIGKILL of one of two elastic replicas under predict and decode
  traffic: no work dropped or duplicated, a declared degraded window,
  generation bumps for the shrink and the re-grow, and, with the
  checkpoint files deleted first, a respawn that adopts the survivors'
  params (``stats()["elastic"]["boot"] == "adopted"``) and serves the
  greedy tokens of the JAX ``greedy_decode_reference`` on the same
  params (JAX ``init``, carried by the port's ``params_from_jax``);
- a seeded chaos plan over the serving sites leaves the pool serving.

Tokens compare exactly; predicts compare with ``pytest.approx``'s
default (1e-6 relative) on ``x * 2`` in float32.  The JAX slow-lane
tests run here in tier 1 at the small size, each under a bound of
:data:`BOUND_S` seconds of its own.  Predicts are module-level
functions of this file (the executors import it), so it imports no JAX
at the top.
"""

import contextlib
import functools
import os
import pickle
import queue as _queue
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch.actors.dispatch import (  # noqa: E402
    InFlightTable,
)
from tensorflowonspark_tpu_torch.serving import batcher as B  # noqa: E402
from tensorflowonspark_tpu_torch.serving import elastic as E  # noqa: E402
from tensorflowonspark_tpu_torch.serving import replicas as R  # noqa: E402
from tensorflowonspark_tpu_torch.serving import server as S  # noqa: E402
from tensorflowonspark_tpu_torch.utils import faults  # noqa: E402

ENV = {"OMP_NUM_THREADS": "1"}
HANG = 90      # seconds: the bound of every wait
BOUND_S = 90   # seconds: the bound of each live-pool test
KW = dict(vocab_size=257, dim=64, n_layers=2, n_heads=4, max_seq=64,
          dtype="float32")


def _double_predict(params, inputs, device=None):
    del params, device
    return {"y": np.asarray(inputs["x"]) * 2.0}


def _echo_version(params, inputs, device=None):
    n = inputs["x"].shape[0]
    return {"version": np.full((n,), float(params["version"]), np.float32)}


@contextlib.contextmanager
def _bounded(seconds=BOUND_S):
    t0 = time.monotonic()
    yield
    took = time.monotonic() - t0
    assert took < seconds, f"took {took:.1f} s, over the {seconds} s bound"


# -- slot assignment ----------------------------------------------------------

def test_assign_slots_even_with_remainder():
    from tensorflowonspark_tpu.serving import elastic as JE

    assert E.assign_slots(4, [0, 1]) == {0: 2, 1: 2}
    assert E.assign_slots(5, [2, 0, 1]) == {0: 2, 1: 2, 2: 1}
    assert E.assign_slots(3, [1]) == {1: 3}
    assert E.assign_slots(3, []) == {}
    assert sum(E.assign_slots(7, [0, 1, 2]).values()) == 7
    rng = np.random.default_rng(3)
    for logical in range(1, 13):
        for _ in range(6):
            live = sorted(rng.choice(12, size=int(rng.integers(0, 7)),
                                     replace=False).tolist())
            assert E.assign_slots(logical, live) == \
                JE.assign_slots(logical, live), (logical, live)


# -- quiesced dispatch (the drain's primitive) ---------------------------------

def test_inflight_quiesce_and_owned_count():
    t = InFlightTable(pool_size=2)
    t.up(0, 100)
    t.up(1, 101)
    t.quiesce(0)
    for i in range(4):
        assert t.add(("batch", i), {"blob": b""}) == 1
    assert t.owned_count(1) == 4 and t.owned_count(0) == 0
    t.quiesce(1)
    assert t.add(("batch", 9), {"blob": b""}) in (0, 1)
    t.unquiesce(0)
    t.pop(("batch", 9))
    assert t.add(("batch", 10), {"blob": b""}) == 0


# -- the compile-count contract keyed by the mesh shape -------------------------

def test_predictor_compile_cache_keyed_by_mesh_shape():
    pred = R._Predictor(_double_predict, {}, 0, torch.device("cpu"))
    x = {"x": np.ones((4, 2), np.float32)}
    pred(x)
    pred(x)
    assert len(pred.compiles) == 1
    before = pred.mesh_shape
    ms = E.apply_resize(pred, covered=3, logical=4)
    assert isinstance(ms, float) and ms >= 0
    assert pred.mesh_shape is not None and pred.mesh_shape != before
    pred(x)
    assert len(pred.compiles) == 2
    E.apply_resize(pred, covered=1, logical=4)
    pred(x)
    assert len(pred.compiles) == 3


# -- declared degraded admission ---------------------------------------------------

def test_batcher_capacity_scales_shed_with_retry_after_floor():
    sheds = []
    mb = B.MicroBatcher(lambda b: None, max_batch=8, max_delay_ms=5,
                        queue_max=4,
                        on_shed=lambda d, lim: sheds.append((d, lim)))
    assert not mb.degraded and mb.effective_queue_max() == 4
    mb.set_capacity(0.5)
    assert mb.degraded and mb.effective_queue_max() == 2
    mb.submit({"x": np.ones(1)})
    mb.submit({"x": np.ones(1)})
    with pytest.raises(B.Overloaded) as ei:
        mb.submit({"x": np.ones(1)})
    assert ei.value.limit == 2
    assert ei.value.retry_after >= 0.25
    assert sheds == [(ei.value.depth, 2)]
    mb.set_capacity(0.0)
    assert mb.effective_queue_max() == 0
    mb.set_capacity(0.01)
    assert mb.effective_queue_max() == 1
    mb.set_capacity(1.0)
    assert not mb.degraded and mb.effective_queue_max() == 4
    mb.close()


# -- the boot gate and adoption ---------------------------------------------------

def test_await_boot_directives_and_timeout():
    q = _queue.Queue()
    q.put(("batch", 1, b"stale"))  # the inherited inbox's work is dropped
    q.put(("boot", "adopt", 7, pickle.dumps({"w": 3})))
    assert E.await_boot(q, timeout=5) == ("adopt", 7, {"w": 3})
    q.put(("boot", "cold"))
    assert E.await_boot(q, timeout=5) == ("cold",)
    q.put(("stop",))
    assert E.await_boot(q, timeout=5) == ("stop",)
    assert E.await_boot(_queue.Queue(), timeout=0.3) == ("cold",)


def test_adopt_predictor_uses_mirror_not_disk():
    payload = {"predict": _echo_version}
    pred = E.adopt_predictor(payload, 7, {"version": 7.0}, "cpu")
    assert pred.version == 7
    out, _ms = pred({"x": np.ones((2, 1), np.float32)})
    assert out["version"] == pytest.approx([7.0, 7.0])
    with pytest.raises(ValueError):
        E.adopt_predictor(payload, 7, None)
    # the mirror is host numpy whatever the live leaves are: a tensor
    # never crosses a process
    tree = {"a": torch.arange(3.0), "b": {"c": np.ones(2, np.float32)},
            "d": [torch.zeros(1)]}
    back = pickle.loads(E.params_blob(tree))
    assert isinstance(back["a"], np.ndarray)
    assert isinstance(back["d"][0], np.ndarray)
    np.testing.assert_array_equal(back["a"], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(back["b"]["c"], [1.0, 1.0])


def test_elastic_pool_validates_logical_capacity():
    spec = R.ModelSpec(predict=_double_predict, params={}, device="cpu")
    with pytest.raises(ValueError):
        E.ElasticReplicaPool(spec, num_replicas=2, logical_replicas=1)


# -- the chaos sites -------------------------------------------------------------

def test_serve_chaos_sites_registered_and_fire(monkeypatch):
    from tensorflowonspark_tpu.utils import faults as jfaults

    assert set(faults.SERVE_CHAOS_SITES) <= set(faults.SITES)
    assert faults.SERVE_CHAOS_SITES == jfaults.SERVE_CHAOS_SITES
    plan = faults.random_plan(123, sites=faults.SERVE_CHAOS_SITES)
    assert any(s in plan for s in faults.SERVE_CHAOS_SITES)
    assert plan == jfaults.random_plan(123, sites=jfaults.SERVE_CHAOS_SITES)
    monkeypatch.setenv("TFOS_FAULT_PLAN", "serve.dispatch:exc@2")
    faults._reset_for_tests()
    try:
        faults.check("serve.dispatch", what="batch")       # hit 1
        with pytest.raises(faults.FaultInjected):
            faults.check("serve.dispatch", what="batch")   # hit 2 fires
        faults.check("serve.resize", reason="formed")      # another site
        faults.check("decode.step", replica=0)
    finally:
        monkeypatch.delenv("TFOS_FAULT_PLAN")
        faults._reset_for_tests()


# -- graceful drain on a live pool ---------------------------------------------------

def test_drain_degrades_and_refuses_last_replica():
    spec = R.ModelSpec(predict=_double_predict, params={}, device="cpu")
    with _bounded(), S.Server(spec, num_replicas=2, max_batch=8,
                              max_delay_ms=5, elastic=True, env=ENV,
                              request_timeout=HANG) as srv:
        c = srv.client()
        c.predict({"x": np.ones(2, np.float32)}, timeout=HANG)
        assert srv.pool.generation >= 1 and not srv.pool.degraded
        assert srv.pool.capacity_frac == pytest.approx(1.0)
        assert sum(srv.pool._assignments.values()) == 2

        assert srv.pool.drain(0, timeout=30) is True
        assert srv.pool.live_replicas() == [1]
        assert srv.pool.degraded
        assert srv.pool.capacity_frac == pytest.approx(0.5)
        assert srv.pool.generation >= 2
        assert srv.batcher.degraded  # admission follows the pool
        out = c.predict({"x": np.full(2, 3.0, np.float32)}, timeout=HANG)
        assert out["y"] == pytest.approx([6.0, 6.0])

        desc = srv.summary()["pool"]
        assert desc["degraded"] and desc["live"] == [1]
        assert 0 in desc["draining"] or "0" not in desc["assignments"]
        assert [row["generation"] for row in E.pool_table()
                if row["live"] == [1]]
        from tensorflowonspark_tpu_torch.obs import http as obs_http

        statusz = obs_http.ObsServer(cluster=None, port=0,
                                     interval=999).render_statusz()
        assert [row for row in statusz["pools"] if row["live"] == [1]]
        with pytest.raises(ValueError):
            srv.pool.drain(1)  # never the last live replica
        with pytest.raises(ValueError):
            srv.pool.drain(5)  # not live at all


# -- SIGKILL, resize, adopt, re-grow ----------------------------------------------------

def _jax_params(seed):
    import jax

    from tensorflowonspark_tpu.models import transformer as JT

    return jax.tree_util.tree_map(
        np.asarray, JT.init(jax.random.PRNGKey(seed), JT.Config(**KW)))


def _oracle(params, prompt, max_tokens):
    from tensorflowonspark_tpu import ops as jops
    from tensorflowonspark_tpu.models import transformer as JT

    return JT.greedy_decode_reference(
        params, prompt, JT.Config(**KW, attn_impl="reference"),
        max_tokens=max_tokens,
        attn_fn=functools.partial(jops.mha_reference, causal=True))


def test_elastic_sigkill_adopt_regrow_zero_drop(tmp_path, monkeypatch):
    """SIGKILL one of two elastic replicas under predict and decode
    traffic: zero dropped or duplicated work (predicts exact, token
    streams the JAX oracle's), a declared degraded window, generation
    bumps for the shrink and the re-grow, and, with the checkpoint
    deleted first, a respawn that adopts the survivors' params at the
    pool's version."""
    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.models import transformer as TT
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    params = _jax_params(0)
    ckpt_dir = str(tmp_path / "ckpts")
    ckpt.save_checkpoint(ckpt_dir, params, step=7)
    monkeypatch.setenv("TFOS_SERVE_RELOAD_SECS", "3600")  # no reloads
    spec = R.ModelSpec(
        predict=_double_predict, ckpt_dir=ckpt_dir, device="cpu",
        decode=serving.DecodeSpec(TT.Config(**KW), slots=4, max_tokens=16))
    prompt = [2, 3, 5, 7]
    oracle = _oracle(params, prompt, 12)

    with _bounded(), S.Server(spec, num_replicas=2, elastic=True,
                              max_batch=8, max_delay_ms=5, queue_max=10_000,
                              env=ENV, request_timeout=HANG) as srv:
        c = srv.client()
        c.predict({"x": np.ones(2, np.float32)}, timeout=HANG)
        srv.generate(prompt, max_tokens=2, timeout=HANG)
        assert set(srv.pool.versions().values()) == {7}
        gen0 = srv.pool.generation
        assert gen0 >= 1
        # a replica that booted after another's mirror arrived adopted at
        # formation already: the respawn's adoption is one more
        adoptions0 = srv.pool.adoptions
        respawns0 = srv.pool.respawns_observed
        # from here step 7 lives only in the replicas and the mirror
        shutil.rmtree(ckpt_dir)

        degraded_seen = threading.Event()
        stop_watch = threading.Event()

        def watch():
            while not stop_watch.is_set():
                if srv.pool.degraded:
                    degraded_seen.set()
                time.sleep(0.01)

        results, gens, errors = [], {}, []

        def burst(i):
            for _ in range(12):
                try:
                    r = c.predict({"x": np.full((2,), float(i), np.float32)},
                                  timeout=HANG)
                    results.append((i, r["y"]))
                except Exception as e:  # noqa: BLE001 - asserted below
                    errors.append(e)

        def gen_one(i):
            try:
                gens[i] = srv.generate(prompt, max_tokens=12, timeout=HANG)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        threads = [threading.Thread(target=burst, args=(i,))
                   for i in range(8)]
        threads += [threading.Thread(target=gen_one, args=(i,))
                    for i in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)  # traffic lands on both replicas
        victim = sorted(srv.pool.replica_pids())[0]
        os.kill(srv.pool.replica_pids()[victim], 9)
        for t in threads:
            t.join()

        assert not errors, errors[:3]
        assert len(results) == 96  # no predict dropped
        for i, y in results:
            assert y == pytest.approx([2.0 * i] * 2)
        assert len(gens) == 3      # no session dropped
        for i, out in gens.items():
            assert out["tokens"] == oracle, (i, out["tokens"])

        # the engine respawns the executor at once, so the pool sees the
        # kill when the respawn says hello: wait for its up
        deadline = time.monotonic() + HANG
        while time.monotonic() < deadline:
            if (srv.pool.respawns_observed > respawns0
                    and srv.pool.live_replicas() == [0, 1]
                    and not srv.pool.degraded
                    and srv.pool.adoptions > adoptions0):
                break
            time.sleep(0.1)
        stop_watch.set()
        assert srv.pool.respawns_observed > respawns0
        assert srv.pool.live_replicas() == [0, 1]
        assert not srv.pool.degraded
        assert srv.pool.adoptions > adoptions0
        assert srv.pool.generation >= gen0 + 2  # shrink and re-grow
        assert degraded_seen.is_set(), "the shrink was never declared"
        assert set(srv.pool.versions().values()) == {7}, srv.pool.versions()
        stats = srv.pool.stats(timeout=30)
        assert stats[victim]["elastic"]["boot"] == "adopted"
        assert srv.pool.adoptions == adoptions0 + 1  # the respawn's alone
        after = c.predict({"x": np.full((2,), 9.0, np.float32)},
                          timeout=HANG)
        assert after["y"] == pytest.approx([18.0, 18.0])
        assert srv.generate(prompt, max_tokens=12,
                            timeout=HANG)["tokens"] == oracle
        desc = srv.pool.describe()
        assert desc["capacity"] == pytest.approx(1.0)
        assert desc["mirror_version"] == 7 and desc["mirror_bytes"] > 0
        assert desc["last_resize_ms"] is None or desc["last_resize_ms"] >= 0


def test_serve_chaos_smoke_keeps_serving(monkeypatch):
    """A seeded fault plan over the serving sites: faulted requests may
    error, but the pool keeps serving (a failed resize is retried, a
    failed dispatch fails only its batch)."""
    seed = int(os.environ.get("TFOS_CHAOS_SEED", "2024"))
    plan = faults.random_plan(seed, sites=faults.SERVE_CHAOS_SITES)
    monkeypatch.setenv("TFOS_FAULT_PLAN", plan)
    faults._reset_for_tests()
    spec = R.ModelSpec(predict=_double_predict, params={}, device="cpu")
    try:
        with _bounded(), S.Server(spec, num_replicas=2, max_batch=8,
                                  max_delay_ms=5, elastic=True, env=ENV,
                                  request_timeout=HANG) as srv:
            c = srv.client()
            errors = 0
            for i in range(20):
                try:
                    out = c.predict({"x": np.full((2,), float(i),
                                                  np.float32)}, timeout=HANG)
                    assert out["y"] == pytest.approx([2.0 * i] * 2)
                except Exception:  # noqa: BLE001 - injected
                    errors += 1
            assert errors <= 2, plan
            monkeypatch.delenv("TFOS_FAULT_PLAN")
            faults._reset_for_tests()
            out = c.predict({"x": np.ones(2, np.float32)}, timeout=HANG)
            assert out["y"] == pytest.approx([2.0, 2.0])
            assert srv.pool.live_replicas() == [0, 1]
    finally:
        monkeypatch.delenv("TFOS_FAULT_PLAN", raising=False)
        faults._reset_for_tests()
