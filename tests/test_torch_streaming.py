"""PyTorch port, streaming feeds on the CPU, held against the JAX
package:

- ``TFCluster.train_stream`` feeds micro-batches until a consumer's
  ``DataFeed.terminate()`` sends STOP (the JAX
  ``tests/test_cluster.py::test_train_stream_feeds_until_stop``, the same
  assertions), also when the consumer stops while its feeder is blocked
  on a full shm ring (and over the manager queue): the stream ends
  within the micro-batch in flight; one-partition micro-batches on two
  nodes feed both trainers (the deal carries on across micro-batches);
- ``examples/stop_streaming.py`` sends STOP from another process (the
  JAX ``test_stop_streaming_utility``), after which ``train_stream``
  returns at once;
- ``train(<DStream>)`` and ``shutdown(ssc=)`` under ``tests/sparkstub``
  (the JAX ``tests/test_spark_integration.py::
  test_streaming_dstream_feed_and_ssc_shutdown``; pyspark is absent
  here, so the stub's StreamingContext drives it);
- ``examples/mnist_spark_streaming.main_fun`` over six micro-batches on
  one executor: its losses equal the JAX example's step on the same
  synthetic micro-batches within ``LOSS_RTOL`` (the JAX params carried
  over with ``models/mnist.params_from_jax``), and the export loads in
  the JAX package; ``mnist_reshape`` prints the JAX helper's picture.

Every wait is bounded (``reservation_timeout``, ``feed_timeout``, a
deadline on the stream).  The ``main_fun``s are module-level functions
of this file, which the executors import, so it imports no JAX at the
top.
"""

import argparse
import importlib
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    mnist_reshape,
    mnist_spark_streaming,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB_DIR = os.path.join(REPO, "tests", "sparkstub")
TIMEOUT = 60
LOSS_RTOL = 1e-5
SMALL_RING = 256 << 10     # bytes: a few chunks of RECORD_FLOATS
RECORD_FLOATS = 8192       # 32 KiB a record
BLOCKED_RECORDS = 64       # a micro-batch: far more than the ring holds
DEALT_RECORDS = 10         # a one-partition micro-batch


@pytest.fixture(scope="module")
def engine():
    e = LocalEngine(2, env={"OMP_NUM_THREADS": "2"})
    yield e
    e.stop()


def _run(engine, main_fun, n=2, **kw):
    return TFCluster.run(engine, main_fun, kw.pop("args", []),
                         num_executors=n,
                         input_mode=TFCluster.InputMode.SPARK,
                         reservation_timeout=TIMEOUT, **kw)


# -- node programs (module-level: the executors import them) ------------------

def stream_consumer_fn(args, ctx):
    """The online consumer of the JAX test: terminate once 200 records
    arrived; the count goes to ``stream_total`` in the executor's dir."""
    feed = ctx.get_data_feed(train_mode=True)
    total = 0
    while not feed.should_stop():
        batch = feed.next_batch(50)
        total += len(batch)
        if total >= 200:
            feed.terminate()
            break
    with open("stream_total", "w") as f:
        f.write(str(total))


def dealt_consumer_fn(args, ctx):
    """Count what arrives; the first trainer to hold 30 records
    terminates.  The count goes to ``dealt_total``."""
    feed = ctx.get_data_feed(train_mode=True)
    total = 0
    while not feed.should_stop():
        total += len(feed.next_batch(DEALT_RECORDS))
        if total >= 3 * DEALT_RECORDS:
            feed.terminate()
            break
    with open("dealt_total", "w") as f:
        f.write(str(total))


def dstream_consumer_fn(args, ctx):
    """The JAX integration test's consumer: terminate after 100."""
    feed = ctx.get_data_feed(train_mode=True)
    total = 0
    while not feed.should_stop():
        batch = feed.next_batch(50)
        total += len(batch)
        if total >= 100:
            feed.terminate()
            break


def blocked_consumer_fn(args, ctx):
    """Take one small batch, then stop reading long enough for the
    feeder to fill the ring and block on it, then terminate."""
    feed = ctx.get_data_feed(train_mode=True)
    feed.next_batch(2)
    time.sleep(1.5)
    feed.terminate()
    with open("blocked_total", "w") as f:
        f.write(f"{feed.records} {feed.stats()['transport']}")


class ReadFile:
    """A ``map_partitions`` function: the named file of the executor's
    dir, or None (a class: tasks ship by plain pickle)."""

    def __init__(self, name):
        self.name = name

    def __call__(self, it):
        list(it)
        try:
            with open(self.name) as f:
                return [f.read()]
        except OSError:
            return [None]


# -- train_stream ---------------------------------------------------------

def test_train_stream_feeds_until_stop(engine):
    """Micro-batches stop once a consumer terminates (the JAX test's
    assertions)."""
    cluster = _run(engine, stream_consumer_fn)

    def micro_batches():
        for _ in range(200):  # long but finite: a hang fails the test
            yield engine.parallelize(range(100), 2)

    cluster.train_stream(micro_batches(), feed_timeout=30)
    assert cluster.server.done.is_set(), "the stream should end on STOP"
    cluster.shutdown()
    totals = engine.parallelize(range(2), 2).map_partitions(
        ReadFile("stream_total")).collect(placement=[0, 1])
    # at least the terminating consumer saw its 200 records
    assert max(int(t) for t in totals) >= 200, totals


def test_train_stream_deals_one_partition_batches_to_every_node(engine):
    """One-partition micro-batches on two nodes: the deal carries on
    across micro-batches, so both trainers are fed (a deal restarted at
    the first node each micro-batch would starve the second), and the
    stream ends on the first trainer's STOP."""
    cluster = _run(engine, dealt_consumer_fn)

    def micro_batches():
        for _ in range(200):  # long but finite: a hang fails the test
            yield engine.parallelize(range(DEALT_RECORDS), 1)

    cluster.train_stream(micro_batches(), feed_timeout=30)
    assert cluster.server.done.is_set(), "the stream should end on STOP"
    cluster.shutdown()
    totals = sorted(int(t) for t in engine.parallelize(range(2), 2)
                    .map_partitions(ReadFile("dealt_total"))
                    .collect(placement=[0, 1]))
    # micro-batches 0, 2, 4 to one trainer (it stops), 1, 3 to the other
    assert totals == [2 * DEALT_RECORDS, 3 * DEALT_RECORDS], totals


@pytest.mark.parametrize("transport", ["shm", "manager"])
def test_stop_reaches_the_stream_while_a_feeder_blocks(transport):
    """The consumer stops reading while its feeder is blocked on a full
    ring (256 KiB against a 2 MiB micro-batch), then terminates: the
    feeder leaves its put, sends STOP, and ``train_stream`` returns
    after the micro-batch in flight; the same over the manager queue."""
    env = {"OMP_NUM_THREADS": "2", "TFOS_SHM_FEED_BYTES": str(SMALL_RING),
           "TFOS_FEED_CHUNK": "2"}
    if transport == "manager":
        env["TFOS_SHM_FEED"] = "0"
    eng = LocalEngine(1, env=env)
    try:
        cluster = _run(eng, blocked_consumer_fn, n=1)
        rows = [np.full(RECORD_FLOATS, i, np.float32)
                for i in range(BLOCKED_RECORDS)]
        pulled = []

        def micro_batches():
            for i in range(50):
                pulled.append(i)
                yield eng.parallelize(rows, 1)

        t0 = time.monotonic()
        cluster.train_stream(micro_batches(), feed_timeout=TIMEOUT)
        took = time.monotonic() - t0
        assert cluster.server.done.is_set()
        # the first micro-batch's feeder saw the STOP; the loop pulled
        # one more micro-batch, found STOP set and fed nothing
        assert pulled == [0, 1], pulled
        assert took < TIMEOUT, took
        cluster.shutdown()
        got, seen = eng.parallelize([0], 1).map_partitions(
            ReadFile("blocked_total")).collect()[0].split()
        assert seen == transport
        assert int(got) < BLOCKED_RECORDS
    finally:
        eng.stop()


def test_stop_streaming_utility(engine):
    """STOP from outside the driver through the rendezvous address (the
    example run as a module, as a user runs it); the stream's loop then
    returns at once."""
    cluster = _run(engine, stream_consumer_fn)
    host, port = cluster.cluster_meta["server_addr"]
    proc = subprocess.run(
        [sys.executable, "-m",
         "tensorflowonspark_tpu_torch.examples.stop_streaming", host,
         str(port)], cwd=REPO, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    assert f"sent STOP to {host}:{port}" in proc.stdout
    assert cluster.server.done.wait(15)

    def micro_batches():
        while True:  # never consumed: STOP is already set
            yield engine.parallelize(range(10), 2)

    cluster.train_stream(micro_batches())  # returns at once
    cluster.shutdown()


# -- DStreams under the pyspark stub -------------------------------------

def _have_real_pyspark():
    try:
        import pyspark  # noqa: F401

        return "sparkstub" not in os.path.dirname(pyspark.__file__)
    except ImportError:
        return False


@pytest.fixture(scope="module")
def spark():
    """A SparkContext (real if installed, the stub otherwise), 2
    executors."""
    added = False
    if not _have_real_pyspark() and STUB_DIR not in sys.path:
        sys.path.insert(0, STUB_DIR)
        added = True
    importlib.invalidate_caches()
    import pyspark

    conf = pyspark.SparkConf().set("spark.executor.instances", "2")
    if _have_real_pyspark():
        conf.setMaster(os.environ.get("MASTER", "local[2]"))
        conf.setAppName("tfos-torch-streaming-tests")
    sc = pyspark.SparkContext(conf=conf)
    yield sc
    sc.stop()
    if added:
        sys.path.remove(STUB_DIR)
        for name in [m for m in sys.modules if m.split(".")[0] == "pyspark"]:
            del sys.modules[name]


def test_streaming_dstream_feed_and_ssc_shutdown(spark):
    """A DStream's micro-batch RDDs feed the trainers through
    ``foreachRDD``; ``shutdown(ssc=)`` stops the context once the
    consumer's STOP arrived (the JAX test's assertions)."""
    from pyspark.streaming import StreamingContext

    cluster = TFCluster.run(spark, dstream_consumer_fn, [], num_executors=2,
                            input_mode=TFCluster.InputMode.SPARK,
                            reservation_timeout=TIMEOUT)
    ssc = StreamingContext(spark, batchDuration=1)
    rdds = [spark.parallelize(range(100), 2) for _ in range(60)]
    stream = ssc.queueStream(rdds)
    cluster.train(stream, feed_timeout=30)  # registers foreachRDD
    ssc.start()
    cluster.shutdown(ssc=ssc, grace_secs=1)
    assert cluster.server.done.is_set(), "the consumer's STOP never came"
    assert ssc._stopped.is_set() if hasattr(ssc, "_stopped") else True


# -- the streaming MNIST example ------------------------------------------

def _jax_example_module(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", os.path.join(REPO, "examples", "mnist",
                                             f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_stream_losses(params, micro_batches, per_proc, lr):
    """The JAX example's ``main_fun`` loop over the same records in
    order: batches of ``per_proc``, the short tail padded."""
    import jax
    import jax.numpy as jnp
    import optax

    from tensorflowonspark_tpu.models import mnist as JM

    opt = optax.sgd(lr, momentum=0.9)
    state = opt.init(params)
    step = jax.jit(JM.make_train_step(opt))
    records = [r for mb in micro_batches for r in mb]
    losses = []
    for i in range(0, len(records), per_proc):
        batch = records[i:i + per_proc]
        images = np.stack([b[0] for b in batch]).astype(np.float32)
        labels = np.asarray([b[1] for b in batch], dtype=np.int32)
        if len(batch) < per_proc:
            reps = -(-per_proc // len(batch))
            images = np.tile(images, (reps, 1, 1, 1))[:per_proc]
            labels = np.tile(labels, reps)[:per_proc]
        params, state, loss, _ = step(params, state, jnp.asarray(images),
                                      jnp.asarray(labels))
        losses.append(float(loss))
    return losses


def test_mnist_spark_streaming_matches_the_jax_example(tmp_path):
    import jax

    from tensorflowonspark_tpu.models import mnist as JM
    from tensorflowonspark_tpu.utils import checkpoint as jckpt

    ns = argparse.Namespace(micro_batches=6, batch_size=16, cluster_size=1,
                            interval=0.0)
    lr = 0.05
    jax_setup = _jax_example_module("mnist_data_setup")
    pj = JM.init_params(jax.random.PRNGKey(0))
    eng = LocalEngine(1, env={"OMP_NUM_THREADS": "2"})
    try:
        seen = []

        def stream():
            for ds in mnist_spark_streaming.micro_batch_stream(eng, ns):
                (part, _), = ds._tasks  # one partition, no lineage
                seen.append(part)
                yield ds

        cluster = _run(eng, mnist_spark_streaming.main_fun, n=1, args={
            "batch_size": ns.batch_size, "lr": lr, "device": "cpu",
            "init_params": jax.tree_util.tree_map(np.asarray, pj),
            "out_dir": str(tmp_path), "model_dir": str(tmp_path)})
        cluster.train_stream(stream(), feed_timeout=TIMEOUT)
        cluster.shutdown()
    finally:
        eng.stop()
    # the port's micro-batches are the JAX example's
    assert len(seen) == ns.micro_batches
    for i, mb in enumerate(seen):
        images, labels = jax_setup.synthetic_mnist(2 * ns.batch_size, seed=i)
        np.testing.assert_array_equal(np.stack([r[0] for r in mb]), images)
        np.testing.assert_array_equal([r[1] for r in mb], labels)
    import json

    report = json.load(open(tmp_path / "stream-rank0.json"))
    assert report["records"] == 2 * ns.batch_size * ns.micro_batches
    want = _jax_stream_losses(pj, seen, ns.batch_size, lr)
    assert len(report["losses"]) == len(want) == 12
    np.testing.assert_allclose(report["losses"], want, rtol=LOSS_RTOL)
    params, meta = jckpt.load_exported(str(tmp_path / "export"))
    assert meta["predict"] == \
        "tensorflowonspark_tpu_torch.models.mnist:predict"
    assert set(params) == set(pj)


def test_pad_tail_is_the_jax_examples():
    rng = np.random.default_rng(0)
    images = rng.random((3, 28, 28, 1), dtype=np.float32)
    labels = np.arange(3)
    got_i, got_l = mnist_spark_streaming.pad_tail(images, labels, 8)
    reps = -(-8 // 3)
    np.testing.assert_array_equal(got_i,
                                  np.tile(images, (reps, 1, 1, 1))[:8])
    np.testing.assert_array_equal(got_l, np.tile(labels, reps)[:8])
    same = mnist_spark_streaming.pad_tail(images, labels, 3)
    assert same[0] is images and same[1] is labels


def test_mnist_reshape_prints_the_jax_helpers_picture():
    spec = importlib.util.spec_from_file_location(
        "_jax_mnist_reshape",
        os.path.join(REPO, "examples", "utils", "mnist_reshape.py"))
    jax_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_mod)
    rng = np.random.default_rng(1)
    pix = rng.integers(0, 256, 784)
    rows = [",".join(str(v) for v in pix),
            "7," + ",".join(str(v) for v in pix) + "\n",
            ",".join(f"{v:.1f}" for v in rng.random(784) * 255)]
    for row in rows:
        got = mnist_reshape.reshape(row)
        assert got == jax_mod.reshape(row)
        assert len(got.splitlines()) == 28
    proc = subprocess.run(
        [sys.executable, "-m",
         "tensorflowonspark_tpu_torch.examples.mnist_reshape", rows[0]],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.stdout.rstrip("\n") == jax_mod.reshape(rows[0])
