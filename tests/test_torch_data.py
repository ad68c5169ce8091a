"""PyTorch port, the input pipeline and the static data service, on the
CPU, held against the JAX package (``tensorflowonspark_tpu/data``).

The same seeded arrays and TFRecord shards go through the same graph in
both packages; the blocks must be equal element for element (exact:
the graphs move records, they compute nothing but ``_double``'s exact
float doubling), and ``block_to_chunk`` must give the same wire chunk.
``DataService`` of both packages, each over its own package's managers
and rendezvous server, must deliver the same per-trainer chunk streams
and resume at the same unit.  End to end: ``cluster.run(data_workers=2,
data_dispatch="static")`` feeds MNIST on a 2-executor engine with the
losses of feeder-mode ``train()`` over the same records (rtol 1e-6:
the same float32 steps on the same batches), also when the serving data
worker is SIGKILLed at a unit's start and resumes from the ledger, and
when the trainer's executor dies and ``_recover`` brings the cluster
back, in both dispatch modes.
"""

import json
import os
import pickle
import secrets

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu import data as jdata  # noqa: E402
from tensorflowonspark_tpu import manager as jmanager  # noqa: E402
from tensorflowonspark_tpu import recordio as jrecordio  # noqa: E402
from tensorflowonspark_tpu import rendezvous as jrendezvous  # noqa: E402
from tensorflowonspark_tpu.data import service as jservice  # noqa: E402
from tensorflowonspark_tpu.utils import faults as jfaults  # noqa: E402
from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import (  # noqa: E402
    data,
    gpu_info,
    manager,
    marker,
    rendezvous,
)
from tensorflowonspark_tpu_torch.data import service  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.examples import mnist_spark  # noqa: E402
from tensorflowonspark_tpu_torch.feed import DataFeed  # noqa: E402
from tensorflowonspark_tpu_torch.utils import faults  # noqa: E402

TIMEOUT = 90  # seconds: registration, collectives, feed consumption
LOSS_RTOL = 1e-6


def _arrays(n, width=4, seed=0):
    """Seeded records; ``y[i] == i`` is each record's identity."""
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, width)).astype(np.float32),
            "y": np.arange(n, dtype=np.int64)}


def _double(block):
    """A ``parallel_map`` function: module level, so it pickles."""
    return {"x": block["x"] * 2.0, "y": block["y"]}


def _write_shards(d, n_shards=4, per_shard=12, seed=0):
    """``n_shards`` TFRecord shards of seeded float/int64/bytes records,
    written by the JAX package's writer (both packages read them)."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    k = 0
    for s in range(n_shards):
        with jrecordio.TFRecordWriter(os.path.join(d, f"part-r-{s:05d}")) \
                as w:
            for _ in range(per_shard):
                w.write(jrecordio.encode_example({
                    "x": ("float", [float(v) for v in rng.random(2)]),
                    "y": ("int64", [k]),
                    "b": ("bytes", [bytes(rng.integers(0, 256, 3,
                                                       dtype=np.uint8))])}))
                k += 1
    return d, n_shards * per_shard


def _assert_blocks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            if isinstance(w[name], np.ndarray):
                assert isinstance(g[name], np.ndarray), name
                assert g[name].dtype == w[name].dtype, name
                np.testing.assert_array_equal(g[name], w[name])
            else:
                assert list(g[name]) == list(w[name]), name


# -- the graph, against the JAX package ----------------------------------------

def _graph(case, pkg, tmp):
    """``case``'s pipeline in package ``pkg`` (its ``data`` module) and
    the terminal to read it by."""
    if case == "shuffle_batch":
        return pkg.from_arrays(_arrays(53), 8).shuffle(17, seed=3).batch(8), {}
    if case == "batch_drop_remainder":
        return pkg.from_arrays(_arrays(53), 8).batch(
            12, drop_remainder=True), {}
    if case == "batch_keep_remainder":
        return pkg.from_arrays(_arrays(53), 5).batch(12), {}
    if case == "shuffle_shard":
        return pkg.from_arrays(_arrays(97), 10).shuffle(
            1000, seed=7).shard(1, 3), {}
    if case == "tfrecords_interleave_parallel_map":
        d, _ = _write_shards(os.path.join(tmp, "tfr"))
        return (pkg.from_tfrecords(d, block_size=5).interleave(2)
                .parallel_map(_double, num_workers=2)), {}
    if case == "tfrecords_shuffle_shard":
        d, _ = _write_shards(os.path.join(tmp, "tfr"))
        return (pkg.from_tfrecords(d, block_size=7).shuffle(20, seed=11)
                .shard(0, 2).batch(6)), {}
    if case == "cache_spill_repeat_prefetch":
        spill = os.path.join(tmp, "spill")
        os.makedirs(spill, exist_ok=True)
        return (pkg.from_arrays(_arrays(60), 7)
                .cache(spill_dir=spill, memory_bytes=128)
                .repeat(2).prefetch(2)), {}
    if case == "skip_blocks":
        return pkg.from_arrays(_arrays(40), 6).shuffle(9, seed=1), \
            {"skip_blocks": 3}
    if case == "blocks_range":
        return pkg.from_arrays(_arrays(40), 6).batch(4), \
            {"range": (2, 3)}
    raise ValueError(case)


def _read(pipe, how):
    if "range" in how:
        return list(pipe.blocks_range(*how["range"]))
    return list(pipe.blocks(skip_blocks=how.get("skip_blocks", 0)))


@pytest.mark.parametrize("case", [
    "shuffle_batch", "batch_drop_remainder", "batch_keep_remainder",
    "shuffle_shard", "tfrecords_interleave_parallel_map",
    "tfrecords_shuffle_shard", "cache_spill_repeat_prefetch",
    "skip_blocks", "blocks_range"])
def test_pipeline_blocks_match_jax(case, tmp_path):
    """The same graph over the same seeded inputs gives the same blocks
    in both packages, element for element (a cached graph twice: its
    fill and its replay)."""
    jt, pt = tmp_path / "jax", tmp_path / "port"
    jpipe, how = _graph(case, jdata, str(jt))
    ppipe, _ = _graph(case, data, str(pt))
    want = _read(jpipe, how)
    assert want, case
    _assert_blocks_equal(_read(ppipe, how), want)
    if case.startswith("cache"):
        _assert_blocks_equal(_read(ppipe, how), want)


def test_block_to_chunk_and_signature_match_jax():
    """``block_to_chunk`` gives the JAX package's spec, columns and
    shapes (fields sorted by name, n-D columns flattened with their
    trailing shape, bytes as an object column), and ``signature`` the
    same digest."""
    rng = np.random.default_rng(5)
    block = {"image": rng.integers(0, 256, (6, 4, 5, 3), dtype=np.uint8),
             "vec": rng.standard_normal((6, 3)).astype(np.float32),
             "label": np.arange(6, dtype=np.int64),
             "raw": [bytes([i]) * 3 for i in range(6)],
             "mask": np.array([True, False] * 3)}
    want = jdata.block_to_chunk(block)
    got = data.block_to_chunk(block)
    assert isinstance(got, marker.ColumnChunk)
    assert got.spec == want.spec and got.shapes == want.shapes
    assert got.meta is None and want.meta is None
    for g, w in zip(got.columns, want.columns):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        else:
            assert list(g) == list(w)
    for build in (lambda m: m.from_arrays(_arrays(30), 4).shuffle(8, 2),
                  lambda m: m.from_arrays(_arrays(30), 4).batch(5, True)
                  .shard(1, 2).repeat(3)):
        assert build(data).signature() == build(jdata).signature()


def test_pipeline_pickles_for_a_worker(tmp_path):
    """A pipeline crosses to a data worker by plain pickle: a cache ships
    empty and fills there; a closure is refused with a clear error."""
    pipe = data.from_arrays(_arrays(30), 4).cache(
        spill_dir=str(tmp_path), memory_bytes=64).batch(7)
    first = list(pipe.blocks())
    copy = pickle.loads(pickle.dumps(pipe))
    _assert_blocks_equal(list(copy.blocks()), first)
    _assert_blocks_equal(list(copy.blocks()), first)
    with pytest.raises(ValueError, match="must pickle"):
        data.from_arrays(_arrays(4), 2).parallel_map(lambda b: b)


# -- the wire: chunks into DataFeed --------------------------------------------

@pytest.fixture
def mgr():
    m = manager.start(secrets.token_bytes(8), ["input", "output", "error"])
    yield m
    m.shutdown()


def test_chunks_feed_datafeed_as_named_columns(mgr):
    """Pipeline chunks are named columns, never ``marker.BARE``: n-D
    fields come back dense in their shape through
    ``next_batch_columns``, and a split-tagged chunk reads back as rows
    of its named fields (sorted), not as bare records."""
    n = 48
    images = np.arange(n * 4 * 6 * 3, dtype=np.uint8).reshape(n, 4, 6, 3)
    labels = np.arange(n, dtype=np.int64)
    pipe = data.from_arrays({"image": images, "label": labels}, 16)
    q = mgr.queue("input")
    for c in pipe.chunks():
        assert c.meta is None and c.meta != marker.BARE
        q.put(c)
    q.put(None)
    feed = DataFeed(mgr, train_mode=True,
                    input_mapping={"image": "image", "label": "label"})
    b = feed.next_batch_columns(16)
    assert b["image"].shape == (16, 4, 6, 3) and b["image"].dtype == np.uint8
    np.testing.assert_array_equal(b["image"], images[:16])
    got = [int(v) for v in b["label"]]
    while not feed.should_stop():
        got.extend(int(v) for v in feed.next_batch_columns(16)["label"])
    assert got == list(range(n))

    tagged = data.block_to_chunk({"y": labels[:3], "x": labels[:3] * 2})
    tagged.meta = marker.split_tag((0, 4), 0)
    assert marker.is_split_tag(tagged.meta)
    assert not marker.is_split_tag(marker.BARE)
    q.put(tagged)
    q.put(None)
    rows = DataFeed(mgr, train_mode=True).next_batch(3)
    assert rows == [(0, 0), (2, 1), (4, 2)]


@pytest.mark.parametrize("pull", ["next_batch", "next_batch_columns"])
def test_datafeed_pull_records_the_jax_packages_fed_consumer_span(
        pull, tmp_path, monkeypatch):
    """With telemetry on, each pull of the port's ``DataFeed`` records the
    ``data/stage`` span that the JAX package's records, stage
    ``fed_consumer``: the pull's wall time less its transport wait, with
    ``wait_ms`` and ``records``.  Both packages' feeds are driven the same
    way here (row chunks of 10 through their own manager, pulls of 16
    until end-of-feed) and give the same names, fields and record
    counts."""
    from tensorflowonspark_tpu import feed as jfeed
    from tensorflowonspark_tpu.utils import telemetry as jtelemetry
    from tensorflowonspark_tpu_torch.utils import telemetry

    rows = [(float(i), i) for i in range(40)]
    got = {}
    for name, tel, mgr_mod, feed_cls in (
            ("jax", jtelemetry, jmanager, jfeed.DataFeed),
            ("torch", telemetry, manager, DataFeed)):
        monkeypatch.setenv(tel.DIR_ENV, str(tmp_path / name))
        monkeypatch.setenv(tel.NODE_ENV, f"{name}-0")
        monkeypatch.delenv(tel.SPOOL_ENV, raising=False)
        monkeypatch.delenv(tel.ROLE_ENV, raising=False)
        assert tel.enabled()
        m = mgr_mod.start(secrets.token_bytes(8), ["input", "output",
                                                   "error"])
        try:
            q = m.get_queue("input")
            for i in range(0, len(rows), 10):
                q.put(rows[i:i + 10])
            q.put(None)
            feed = feed_cls(m, train_mode=True,
                            input_mapping={"x": "x", "y": "y"})
            while not feed.should_stop():
                getattr(feed, pull)(16)
        finally:
            m.shutdown()
        spans = [r for r in tel.recent() if r["name"] == "data/stage"
                 and r["attrs"].get("stage") == "fed_consumer"]
        waits = [r for r in tel.recent() if r["name"] == "feed/wait"]
        got[name] = spans
        assert [r["attrs"]["records"] for r in spans] == [16, 16, 8]
        for r in spans:
            assert r["kind"] == "span" and r["dur_ms"] >= 0
            assert r["attrs"]["wait_ms"] >= 0
        # the waits the spans subtract are the feed/wait spans' own
        assert sum(r["attrs"]["wait_ms"] for r in spans) == pytest.approx(
            sum(r["dur_ms"] for r in waits), abs=0.01)
        monkeypatch.delenv(tel.DIR_ENV)
    assert [sorted(r["attrs"]) for r in got["torch"]] == \
        [sorted(r["attrs"]) for r in got["jax"]]


# -- the static service, against the JAX package --------------------------------

def _trainer_meta(m, executor_id, authkey):
    return {"executor_id": executor_id, "host": "localhost",
            "job_name": "worker", "addr": list(m.address),
            "authkey": authkey.hex()}


def _drain(q):
    out = []
    while not q.empty():
        out.append(q.get())
        q.task_done()
    return out


def _assert_chunks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.spec == w.spec and g.shapes == w.shapes
        for a, b in zip(g.columns, w.columns):
            np.testing.assert_array_equal(a, b)


def _static_streams(pkg_manager, pkg_service, pkg_data, n_trainers,
                    n_workers):
    keys = [secrets.token_bytes(8) for _ in range(n_trainers)]
    mgrs = [pkg_manager.start(k, ["input", "output", "error"])
            for k in keys]
    try:
        info = [_trainer_meta(m, i, k)
                for i, (m, k) in enumerate(zip(mgrs, keys))]
        pipe = pkg_data.from_arrays(_arrays(41), 5).shuffle(13, seed=4)
        summaries = [pkg_service.DataService(
            pipe, info, cluster_meta={}, num_workers=n_workers,
            worker_index=w, unit_blocks=2).run() for w in range(n_workers)]
        return summaries, [_drain(m.get_queue("input")) for m in mgrs]
    finally:
        for m in mgrs:
            m.shutdown()


@pytest.mark.parametrize("n_trainers,n_workers", [(2, 2), (3, 2), (1, 2)])
def test_static_service_streams_match_jax(n_trainers, n_workers):
    """Worker ``j`` serves the trainers with ``rank % N == j``, each the
    strided ``shard(rank, T)`` of the pipeline: the port's workers give
    every trainer the chunks the JAX package's give it."""
    jsum, jstreams = _static_streams(jmanager, jservice, jdata, n_trainers,
                                     n_workers)
    psum, pstreams = _static_streams(manager, service, data, n_trainers,
                                     n_workers)
    assert psum == jsum
    for got, want in zip(pstreams, jstreams):
        _assert_chunks_equal(got, want)
    ids = sorted(int(v) for s in pstreams for c in s for v in c.columns[1])
    assert ids == list(range(41))


def _resume_run(pkg_manager, pkg_rendezvous, pkg_service, pkg_data, plan_env,
                reset):
    os.environ[plan_env] = "data.serve:exc@2"
    reset()
    authkey = secrets.token_bytes(8)
    m = pkg_manager.start(authkey, ["input", "output", "error"])
    server = pkg_rendezvous.Server(1)
    addr = server.start()
    try:
        info = [_trainer_meta(m, 0, authkey)]
        pipe = pkg_data.from_arrays(_arrays(100), 10)

        def svc():
            return pkg_service.DataService(pipe, info, {"server_addr": addr},
                                           num_workers=1, worker_index=0,
                                           unit_blocks=4)

        with pytest.raises(Exception, match="injected fault"):
            svc().run()
        first = server.fed_partitions(pkg_service.ledger_feed("input", 0))
        os.environ.pop(plan_env)
        reset()
        summary = svc().run()
        done = server.fed_partitions(pkg_service.ledger_feed("input", 0))
        ids = [int(v) for c in _drain(m.get_queue("input"))
               for v in c.columns[1]]
        return first, summary, done, ids
    finally:
        os.environ.pop(plan_env, None)
        reset()
        server.stop()
        m.shutdown()


def _reset_port_faults():
    faults._state.update(pid=None, plan=None, faults=(), hits={})


def test_static_service_resumes_at_the_unit_the_jax_one_does():
    """A worker faulted at unit 1's start leaves unit 0 in the ledger; a
    fresh worker resumes at unit 1, pushes the rest once, and records
    the short tail unit at the end, in both packages alike."""
    want = _resume_run(jmanager, jrendezvous, jservice, jdata,
                       jfaults.PLAN_ENV, jfaults._reset_for_tests)
    got = _resume_run(manager, rendezvous, service, data, faults.PLAN_ENV,
                      _reset_port_faults)
    assert got == want
    assert got[0] == [0] and got[2] == [0, 1, 2]
    assert got[3] == list(range(100))


def test_static_service_skips_a_terminating_trainer():
    authkey = secrets.token_bytes(8)
    m = manager.start(authkey, ["input", "output", "error"])
    try:
        m.set("state", "terminating")
        svc = service.DataService(data.from_arrays(_arrays(10), 5),
                                  [_trainer_meta(m, 0, authkey)], {},
                                  num_workers=1, worker_index=0)
        assert svc.run() == {0: 0}
        assert m.get_queue("input").empty()
        assert service.dispatch_mode({"data_dispatch": "static"}) == "static"
        assert service.dispatch_mode({}) == "dynamic"
        with pytest.raises(ValueError, match="static|dynamic"):
            service.dispatch_mode({"data_dispatch": "round-robin"})
    finally:
        m.shutdown()


# -- end to end: the static service feeds MNIST on a cluster --------------------

MNIST = dict(batch=16, steps=12, block=16, lr=0.05)


def _engine(**env):
    """Two executors: the trainer's node on executor 0, the serving data
    worker on executor 1 (the cluster places workers off the nodes
    first)."""
    return LocalEngine(2, env=dict({
        "OMP_NUM_THREADS": "2", gpu_info.COUNT_ENV: "0",
        "CUDA_VISIBLE_DEVICES": None, gpu_info.INHERITED_ENV: None}, **env))


def _mnist_records():
    rows = mnist_spark.synthetic_records(MNIST["batch"] * MNIST["steps"],
                                         seed=4)
    images = np.stack([r[0] for r in rows]).astype(np.float32)
    labels = np.asarray([r[1] for r in rows], np.int32)
    return rows, images, labels


def _train(engine, tmp_path, dataset, name, **kw):
    out = tmp_path / name
    out.mkdir()
    c = TFCluster.run(engine, mnist_spark.main_fun,
                      {"batch_size": MNIST["batch"], "lr": MNIST["lr"],
                       "device": "cpu", "seed": 0, "out_dir": str(out)},
                      num_executors=1, input_mode=TFCluster.InputMode.SPARK,
                      reservation_timeout=TIMEOUT, **kw)
    try:
        c.train(dataset, feed_timeout=TIMEOUT)
        fed = c.server.fed_partitions(service.ledger_feed("input", 0))
    finally:
        c.shutdown()
    with open(out / "mnist-rank0.json") as f:
        return json.load(f), fed, c


def test_static_service_mnist_gives_the_feeder_losses(tmp_path):
    """MNIST through ``cluster.run(data_workers=2, data_dispatch=
    "static")`` steps on the batches feeder-mode ``train()`` gives it over
    the same records, so its losses are the feeder's (rtol 1e-6); both
    units (8 blocks and a short 4) land in the trainer's unit ledger.
    Then the same with the serving worker SIGKILLed at unit 1's start
    (``data.serve:kill@2``, scoped to executor 1's first incarnation):
    the engine respawns the executor, the worker resumes at unit 1 from
    the ledger, the cluster needs no recovery, and the losses are still
    the feeder's."""
    rows, images, labels = _mnist_records()
    pipe = data.from_arrays({"image": images, "label": labels},
                            MNIST["block"])
    engine = _engine()
    try:
        feeder, _, _ = _train(engine, tmp_path,
                              engine.parallelize(rows, 3), "feeder")
        served, fed, _ = _train(engine, tmp_path, pipe, "static",
                                data_workers=2, data_dispatch="static")
    finally:
        engine.stop()
    assert len(feeder["losses"]) == MNIST["steps"]
    np.testing.assert_allclose(served["losses"], feeder["losses"],
                               rtol=LOSS_RTOL)
    assert fed == [0, 1]
    assert served["feed"]["columnar"]
    assert served["feed"]["split_dup_chunks"] == 0

    engine = _engine(**{faults.PLAN_ENV: "data.serve:kill@2",
                        faults.EXECUTOR_ENV: "1",
                        faults.INCARNATION_ENV: "0"})
    try:
        killed, fed, c = _train(engine, tmp_path, pipe, "killed",
                                data_workers=2, data_dispatch="static",
                                restarts=1)
        incarnations = list(engine._incarnation)
    finally:
        engine.stop()
    assert incarnations == [0, 1]   # the worker's executor was respawned
    assert c._restarts_used == 0    # a worker's death is no cluster failure
    np.testing.assert_allclose(killed["losses"], feeder["losses"],
                               rtol=LOSS_RTOL)
    assert fed == [0, 1]


@pytest.mark.parametrize("dispatch", ["static", "dynamic"])
def test_service_recovers_when_the_trainer_dies(tmp_path, dispatch):
    """The node's executor dies as the service starts
    (``engine.task:kill@2`` on executor 0's first incarnation: its
    second task, worker 1's), reaping the booting trainer: the serving
    worker fails on the lost consumer, the feed job fails, ``_recover``
    brings epoch 1 up, and the next attempt (a new split board in
    dynamic dispatch) feeds what no ledger holds: here everything, so
    the new trainer gives the feeder-mode losses."""
    rows, images, labels = _mnist_records()
    pipe = data.from_arrays({"image": images, "label": labels},
                            MNIST["block"])
    engine = _engine()
    try:
        feeder, _, _ = _train(engine, tmp_path,
                              engine.parallelize(rows, 3), "feeder")
    finally:
        engine.stop()
    engine = _engine(**{faults.PLAN_ENV: "engine.task:kill@2",
                        faults.EXECUTOR_ENV: "0",
                        faults.INCARNATION_ENV: "0",
                        "TFOS_DATA_SPLIT_BLOCKS": "1"})
    try:
        got, fed, c = _train(engine, tmp_path, pipe, dispatch,
                             data_workers=2, data_dispatch=dispatch,
                             restarts=1)
    finally:
        engine.stop()
    assert c._restarts_used == 1 and c.meta["epoch"] == 1
    np.testing.assert_allclose(got["losses"], feeder["losses"],
                               rtol=LOSS_RTOL)
    if dispatch == "static":
        assert fed == [0, 1]
    else:
        assert c.data_status["complete"]
