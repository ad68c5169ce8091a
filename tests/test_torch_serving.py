"""PyTorch port, online predict serving on the CPU, held against the JAX
package where both have the piece:

- the bucket and pad helpers, and ``MicroBatcher`` scenarios
  (coalescing, deadline flush, grouping by signature, sequence
  bucketing, shedding past ``queue_max``, ``close`` failing queued
  requests, ``Batch`` resolving once) driven through both packages with
  a recording dispatch: the batch compositions, buckets and padded
  inputs must be equal;
- a 2-replica ``Server.predict`` round trip with a module-level numpy
  predict, and the compile-count contract (one entry per new signature,
  at most log2(max_batch)+1 of them);
- a JAX-made MNIST export (JAX ``init_params``, JAX ``export_model``
  naming ``tensorflowonspark_tpu.models.mnist:serve_predict``) served by
  the port's pool: logits equal JAX ``serve_predict``'s to 1e-5 of the
  largest logit (float32 on both sides; the convolutions sum in
  another order);
- hot reload from ``ckpt_dir``; the HTTP routes and their status codes
  (200, 400, 404, 503 + ``Retry-After``); a replica SIGKILLed under
  load (160 answers, none dropped, a respawn observed);
- ``TFCluster.serve()`` after a SPARK-fed MNIST run on a 2-executor gloo
  engine, the export's predictions equal to ``mnist.predict`` in this
  process to 1e-5 of the largest logit;
- the driver-side manager leaves no child-pid file in the working dir.

Every wait is a hang guard (``HANG`` seconds) on a condition.  The
predict functions the replicas run are module-level functions of this
file, which imports no JAX at the top (executors import it).
"""

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

from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import serving  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.examples import mnist_spark  # noqa: E402
from tensorflowonspark_tpu_torch.models import mnist  # noqa: E402
from tensorflowonspark_tpu_torch.serving import batcher as B  # noqa: E402
from tensorflowonspark_tpu_torch.serving import server as S  # noqa: E402
from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

HANG = 120          # seconds: the bound of every wait
LOGIT_RTOL = 1e-5   # of the largest |logit|
ENV = {"OMP_NUM_THREADS": "1"}


def scale_predict(params, inputs, device=None):
    """``{"y": x * w}`` for the single input ``x`` (numpy only)."""
    (x,) = inputs.values()
    return {"y": np.asarray(x, np.float32) * np.float32(params["w"])}


def slow_scale_predict(params, inputs, device=None):
    """:func:`scale_predict` that takes 10 ms a batch, so batches are in
    flight when a replica dies."""
    time.sleep(0.01)
    return scale_predict(params, inputs, device)


def _wait(cond, what):
    deadline = time.monotonic() + HANG
    while not cond():
        assert time.monotonic() < deadline, f"hang guard: {what}"
        time.sleep(0.02)


def _concurrently(fn, n):
    """``fn(i)`` for i < n on n threads; ``({i: result}, {i: error})``."""
    results, errors = {}, {}

    def one(i):
        try:
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 - asserted by callers
            errors[i] = e

    ts = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(HANG)
        assert not t.is_alive(), "hang guard: a request thread"
    return results, errors


# -- helpers and MicroBatcher, both packages ---------------------------------

def _jax_batcher():
    from tensorflowonspark_tpu.serving import batcher

    return batcher


@pytest.mark.parametrize("n,cap", [(1, 64), (3, 64), (8, 8), (9, 8),
                                   (33, 64), (100, 64), (5, 6)])
def test_bucket_and_pad_helpers_match_jax(n, cap):
    J = _jax_batcher()
    assert B.bucket_size(n, cap) == J.bucket_size(n, cap)
    assert B.bucket_seq(n, cap) == J.bucket_seq(n, cap)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    tgt = J.bucket_size(n, cap)
    if tgt >= n:
        np.testing.assert_array_equal(B.pad_rows(x, tgt), J.pad_rows(x, tgt))
        cols = {"a": x, "b": x[:, 0].astype(np.int32)}
        got, ref = B.pad_columns(cols, tgt), J.pad_columns(cols, tgt)
        for k in cols:
            np.testing.assert_array_equal(got[k], ref[k])
    s = np.arange(n, dtype=np.int32)
    t = J.bucket_seq(n, cap)
    if t >= n:
        np.testing.assert_array_equal(B.pad_seq(s, t), J.pad_seq(s, t))


def _record(mod, scenario):
    """Run one MicroBatcher scenario with ``mod``'s batcher and a
    recording dispatch; returns what the scenario observed."""
    seen = []
    lock = threading.Lock()

    def dispatch(batch):
        with lock:
            seen.append((batch.n_valid, batch.bucket,
                         {k: (v.shape, str(v.dtype), v.tolist())
                          for k, v in sorted(batch.inputs.items())}))
        batch.complete({k: v * 2 for k, v in batch.inputs.items()
                        if not k.startswith("_")})

    sheds = []
    kw = dict(max_batch=8, max_delay_ms=300, queue_max=64)
    if scenario == "deadline":
        kw["max_delay_ms"] = 30
    if scenario == "shed":
        kw["queue_max"] = 4
    if scenario == "seq":
        kw.update(seq_axis=0, seq_cap=16)
    mb = mod.MicroBatcher(dispatch, on_shed=lambda d, lim: sheds.append(
        (d, lim)), **kw)
    x = lambda i, n=3, dt=np.float32: {"x": np.full((n,), i, dt)}  # noqa
    if scenario == "coalesce":
        examples = [x(i) for i in range(13)]
    elif scenario == "deadline":
        examples = [x(1)]
    elif scenario == "signatures":
        examples = [x(0), x(1, 2), x(2), x(3, 3, np.int32), x(4, 2), x(5)]
    elif scenario == "seq":
        examples = [{"t": np.arange(n, dtype=np.int32)}
                    for n in (3, 4, 5, 9, 2, 16)]
    else:
        examples = [x(i) for i in range(6)]
    if scenario == "shed":
        reqs = [mb.submit(e) for e in examples[:4]]
        with pytest.raises(mod.Overloaded) as ei:
            mb.submit(examples[4])
        mb.start()
        outs = [r.result(HANG) for r in reqs]
        mb.close()
        return (seen, sheds, (ei.value.depth, ei.value.limit,
                              ei.value.retry_after),
                [o["x"].tolist() for o in outs])
    if scenario == "close":
        reqs = [mb.submit(e) for e in examples]
        mb.close()
        errs = []
        for r in reqs:
            with pytest.raises(RuntimeError) as ei:
                r.result(HANG)
            errs.append(str(ei.value))
        with pytest.raises(RuntimeError, match="closed"):
            mb.submit(examples[0])
        return seen, errs
    if scenario == "resolve_once":
        reqs = [mb.submit(e) for e in examples]
        batch = mod.Batch(99, reqs, {"x": np.stack([e["x"] for e in
                                                    examples])}, 8, 0.0)
        first = batch.complete({"x": np.arange(6)[:, None] * np.ones(3)})
        again = batch.complete({"x": np.zeros((6, 3))})
        failed = batch.fail(RuntimeError("late"))
        return (first, again, failed,
                [r.result(1)["x"].tolist() for r in reqs])
    reqs = [mb.submit(e) for e in examples]
    t0 = time.perf_counter()
    mb.start()
    outs = [r.result(HANG) for r in reqs]
    waited = time.perf_counter() - t0
    mb.close()
    if scenario == "deadline":
        assert waited >= 0.03, waited
    key = "t" if scenario == "seq" else "x"
    return seen, [o[key].tolist() for o in outs]


@pytest.mark.parametrize("scenario", ["coalesce", "deadline", "signatures",
                                      "seq", "shed", "close",
                                      "resolve_once"])
def test_microbatcher_scenarios_match_jax(scenario):
    got = _record(B, scenario)
    ref = _record(_jax_batcher(), scenario)
    assert got == ref
    if scenario == "coalesce":
        assert [(n, b) for n, b, _ in got[0]] == [(8, 8), (5, 8)]
    if scenario == "signatures":
        assert [(n, b) for n, b, _ in got[0]] == [(3, 4), (2, 2), (1, 1)]


# -- a 2-replica pool with a numpy predict ------------------------------------

@pytest.fixture(scope="module")
def srv():
    spec = serving.ModelSpec(predict=scale_predict, params={"w": 2.0},
                             device="cpu")
    s = serving.Server(spec, num_replicas=2, max_batch=8, max_delay_ms=20,
                       env=ENV, request_timeout=HANG).start(timeout=HANG)
    yield s
    s.stop()


def test_predict_round_trip_and_compile_count(srv):
    results, errors = _concurrently(
        lambda i: srv.predict({"x": np.full((3,), i, np.float32)}), 40)
    assert not errors, errors
    for i in range(40):
        np.testing.assert_array_equal(results[i]["y"], np.full((3,), 2 * i))
    summ = srv.summary(include_replicas=True)
    assert summ["completed"] >= 40 and summ["errors"] == 0
    assert summ["replicas"] == [0, 1]
    reps = summ["replica_stats"]
    assert sorted(reps) == [0, 1]
    for r in reps.values():
        assert r["device"] == "cpu"
        # one entry a signature, each seen once, buckets 1..8
        assert set(r["compiles"].values()) <= {1}
        assert len(r["compiles"]) <= 4  # log2(8) + 1
    assert sum(r["rows"] for r in reps.values()) >= 40


def test_http_predict_routes(srv):
    httpd = S.serve_http(srv, port=0, block=False)
    try:
        host, port = httpd.server_address
        base = f"http://{host}:{port}"
        code, _, body = _post(base + "/v1/predict",
                              {"inputs": {"x": [1.0, 2.0]}})
        assert code == 200 and body["outputs"]["y"] == [2.0, 4.0]
        for bad in ({"nope": 1}, {"inputs": []}, {"inputs": {}}):
            assert _post(base + "/v1/predict", bad)[0] == 400, bad
        assert _post(base + "/v1/nope", {})[0] == 404
        with urllib.request.urlopen(base + "/healthz", timeout=HANG) as r:
            assert r.status == 200
            assert json.loads(r.read()) == {"status": "ok",
                                            "replicas": [0, 1]}
        with urllib.request.urlopen(base + "/stats", timeout=HANG) as r:
            assert json.loads(r.read())["completed"] >= 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope", timeout=HANG)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()


class _StubPool:
    def live_replicas(self):
        return []


class _ShedStub:
    """A server whose every request is shed and that has no replica."""

    pool = _StubPool()

    def predict(self, example, timeout=None, trace=None):
        raise B.Overloaded(5, 4, retry_after=0.25)

    def generate(self, prompt, **kw):
        raise B.Overloaded(65, 64, retry_after=0.5)


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HANG) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_http_overload_is_503_with_retry_after():
    httpd = S.serve_http(_ShedStub(), port=0, block=False)
    try:
        host, port = httpd.server_address
        base = f"http://{host}:{port}"
        code, headers, body = _post(base + "/v1/predict",
                                    {"inputs": {"x": [1.0]}})
        assert code == 503 and body["error"] == "overloaded"
        assert float(headers["Retry-After"]) == pytest.approx(0.25)
        code, headers, _ = _post(base + "/v1/generate", {"prompt": [1]})
        assert code == 503
        assert float(headers["Retry-After"]) == pytest.approx(0.5)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz", timeout=HANG)
        assert ei.value.code == 503
    finally:
        httpd.shutdown()


def test_server_sheds_past_queue_max():
    """A stopped pool's server with ``queue_max=2`` whose batcher never
    runs: the third request is shed and counted, never queued."""
    spec = serving.ModelSpec(predict=scale_predict, params={"w": 1.0})
    s = serving.Server(spec, num_replicas=1, queue_max=2)
    s.batcher.submit({"x": np.zeros(1)})
    s.batcher.submit({"x": np.zeros(1)})
    with pytest.raises(B.Overloaded):
        s.predict({"x": np.zeros(1)})
    assert s.summary()["shed"] == 1
    s.batcher.close()


# -- the JAX package's MNIST export, served by the port -----------------------

def test_jax_made_mnist_export_served_by_the_port(tmp_path):
    import jax

    from tensorflowonspark_tpu.models import mnist as JM
    from tensorflowonspark_tpu.utils import checkpoint as jckpt

    pj = jax.tree_util.tree_map(np.asarray,
                                JM.init_params(jax.random.PRNGKey(0)))
    export_dir = str(tmp_path / "export")
    jckpt.export_model(export_dir, pj, metadata={
        "predict": "tensorflowonspark_tpu.models.mnist:serve_predict"})
    images = np.random.default_rng(0).random((12, 28, 28, 1),
                                             dtype=np.float32)
    ref = np.asarray(JM.serve_predict(pj, {"image": images})["logits"])
    spec = serving.ModelSpec(export_dir=export_dir, device="cpu")
    with serving.Server(spec, num_replicas=2, max_batch=4, env=ENV,
                        request_timeout=HANG) as srv:
        results, errors = _concurrently(
            lambda i: srv.predict({"image": images[i]}), len(images))
        reps = srv.summary(include_replicas=True)["replica_stats"]
    assert not errors, errors
    got = np.stack([results[i]["logits"] for i in range(len(images))])
    assert np.abs(got - ref).max() <= LOGIT_RTOL * np.abs(ref).max()
    assert [int(results[i]["prediction"]) for i in range(len(images))] \
        == ref.argmax(-1).tolist()
    for r in reps.values():
        assert len(r["compiles"]) <= 3  # log2(4) + 1


def test_a_jax_predict_without_counterpart_raises():
    from tensorflowonspark_tpu_torch.serving import replicas as R

    assert R._import_qualname(
        "tensorflowonspark_tpu.models.mnist:predict") is mnist.predict
    with pytest.raises(ValueError, match="pass predict="):
        R._import_qualname("tensorflowonspark_tpu.models.resnet:predict")


# -- hot reload ---------------------------------------------------------------

def test_hot_reload_from_ckpt_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TFOS_SERVE_RELOAD_SECS", "0.2")
    ckpt_dir = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(ckpt_dir, {"w": np.float32(3.0)}, step=1)
    spec = serving.ModelSpec(predict=scale_predict, ckpt_dir=ckpt_dir,
                             device="cpu")
    with serving.Server(spec, num_replicas=2, max_delay_ms=1, env=ENV,
                        request_timeout=HANG) as srv:
        assert srv.pool.versions() == {0: 1, 1: 1}
        assert srv.predict({"x": np.ones(2)})["y"].tolist() == [3.0, 3.0]
        ckpt.save_checkpoint(ckpt_dir, {"w": np.float32(5.0)}, step=2)
        _wait(lambda: srv.pool.versions() == {0: 2, 1: 2}, "reload")
        results, errors = _concurrently(
            lambda i: srv.predict({"x": np.ones(2)}), 8)
        assert not errors, errors
        assert all(r["y"].tolist() == [5.0, 5.0] for r in results.values())


# -- failover -----------------------------------------------------------------

def test_sigkill_under_load_drops_nothing():
    spec = serving.ModelSpec(predict=slow_scale_predict, params={"w": 2.0},
                             device="cpu")
    with serving.Server(spec, num_replicas=2, max_batch=4, max_delay_ms=2,
                        env=ENV, request_timeout=HANG) as srv:
        victim_pid = srv.pool.replica_pids()[0]
        answered = []
        lock = threading.Lock()

        def client(c):
            out = []
            for j in range(10):
                v = 10 * c + j
                out.append((v, srv.predict({"x": np.full((2,), v)},
                                           timeout=HANG)))
                with lock:
                    answered.append(v)
            return out

        ts = []
        results, errors = {}, {}

        def run(c):
            try:
                results[c] = client(c)
            except Exception as e:  # noqa: BLE001 - asserted below
                errors[c] = e

        for c in range(16):
            ts.append(threading.Thread(target=run, args=(c,)))
            ts[-1].start()
        _wait(lambda: len(answered) >= 40, "40 answers before the kill")
        os.kill(victim_pid, 9)
        for t in ts:
            t.join(HANG)
            assert not t.is_alive(), "hang guard: a client"
        assert not errors, errors
        got = sorted(v for c in results.values() for v, _ in c)
        assert got == list(range(160))
        for c in results.values():
            for v, row in c:
                assert row["y"].tolist() == [2.0 * v, 2.0 * v]
        _wait(lambda: srv.pool.respawns_observed >= 1
              and srv.pool.live_replicas() == [0, 1], "respawn")
        assert srv.pool.replica_pids()[0] != victim_pid
        assert srv.summary()["completed"] == 160


# -- TFCluster.serve ----------------------------------------------------------

def test_cluster_serve_after_spark_fed_mnist(tmp_path):
    engine = LocalEngine(2, env={"OMP_NUM_THREADS": "2"})
    try:
        records = mnist_spark.synthetic_records(16 * 8, seed=0)
        c = TFCluster.run(
            engine, mnist_spark.main_fun,
            {"batch_size": 16, "lr": 0.05, "device": "cpu", "seed": 0,
             "model_dir": str(tmp_path)},
            num_executors=2, input_mode=TFCluster.InputMode.SPARK,
            master_node="chief", reservation_timeout=HANG)
        c.train(engine.parallelize(records, 4), feed_timeout=HANG)
        c.shutdown()
        export_dir = str(tmp_path / "export")
        params, meta = ckpt.load_exported(export_dir)
        assert meta["predict"] == mnist.PREDICT
        images = np.stack([r[0] for r in records[:16]])
        ref = mnist.predict(params, {"image": images}, device="cpu")
        srv = c.serve(export_dir=export_dir, device="cpu", max_batch=8,
                      request_timeout=HANG)
        try:
            assert srv.pool.live_replicas() == [0, 1]
            results, errors = _concurrently(
                lambda i: srv.predict({"image": images[i]}), 16)
            reps = srv.summary(include_replicas=True)["replica_stats"]
        finally:
            srv.stop()
        assert not errors, errors
        got = np.stack([results[i]["logits"] for i in range(16)])
        want = ref["logits"]
        assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()
        for r in reps.values():
            assert len(r["compiles"]) <= 4  # log2(8) + 1
    finally:
        engine.stop()


# -- the driver-side manager --------------------------------------------------

def test_manager_start_keeps_cwd_clean(tmp_path, monkeypatch):
    """The port's version of tests/test_serving.py's regression: a
    driver-side ``manager.start`` (the pool's) records its server's pid
    in a per-process temp dir, never in the working directory."""
    from tensorflowonspark_tpu_torch import manager
    from tensorflowonspark_tpu_torch.utils import hostinfo

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("TFOS_EXECUTOR_INDEX", raising=False)
    mgr = manager.start(b"test-key-serving", ["q"])
    try:
        assert not (tmp_path / "tfos_child_pids").exists()
        assert mgr._process.pid in hostinfo.read_child_pids()
        assert "tfos-pids-" in hostinfo.child_pids_dir()
    finally:
        mgr.shutdown()
        hostinfo.clear_child_pids()
    assert os.listdir(tmp_path) == []
