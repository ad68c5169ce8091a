"""PyTorch port, the SPARK-fed training path as a whole, on the CPU:
``cluster.run`` -> rendezvous -> node -> forked trainer ->
``torch_initialize`` -> ``DataFeed`` -> ``infeed.device_feed`` -> the
model's step, with the examples' ``main_fun``s
(``tensorflowonspark_tpu_torch/examples``), held against the JAX
package's in-process steps over the same batches.

- MNIST on one executor: the losses of ``mnist.make_train_step(
  optax.sgd(0.05, momentum=0.9))`` to 1e-4 relative (f32 on both sides;
  the sums' order differs by ~1e-7 a step, and SGD carries it along).
- The transformer (2 layers, dim 64) on one executor: the losses of
  ``jax.value_and_grad(transformer.loss_fn)`` with ``optax.adam(1e-3)``
  to 1e-4 relative.
- MNIST on two executors over a gloo group, mirroring
  tests/test_mnist_e2e.py without the export (ROADMAP.md queue 1,
  item 9): the loss falls, both ranks end with equal params, and the
  trainers' ``train/step`` and ``feed/wait`` spans reach the telemetry
  directory.

Every wait is bounded (``reservation_timeout``, ``feed_timeout``).
"""

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    mnist_spark,
    transformer_spark,
)
from tensorflowonspark_tpu_torch.utils import telemetry  # noqa: E402

TIMEOUT = 90
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def telemetry_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("telemetry")


@pytest.fixture(scope="module")
def engine(telemetry_dir):
    e = LocalEngine(2, env={"OMP_NUM_THREADS": "2",
                            telemetry.DIR_ENV: str(telemetry_dir)})
    yield e
    e.stop()


def _train(engine, main_fun, args, records, partitions, n=1, **kw):
    c = TFCluster.run(engine, main_fun, args, num_executors=n,
                      input_mode=TFCluster.InputMode.SPARK,
                      reservation_timeout=TIMEOUT, **kw)
    c.train(engine.parallelize(records, partitions), feed_timeout=TIMEOUT)
    assert c.server.fed_partitions("input") == list(range(partitions))
    c.shutdown()


def test_spark_fed_mnist_matches_jax_steps(engine, tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    from tensorflowonspark_tpu.models import mnist as JM

    batch, steps = 16, 6
    records = mnist_spark.synthetic_records(batch * steps, seed=3)
    pj = JM.init_params(jax.random.PRNGKey(0))
    _train(engine, mnist_spark.main_fun, {
        "batch_size": batch, "lr": 0.05, "device": "cpu",
        "init_params": jax.tree_util.tree_map(np.asarray, pj),
        "out_dir": str(tmp_path)}, records, 3)
    got = json.load(open(tmp_path / "mnist-rank0.json"))["losses"]

    opt = optax.sgd(0.05, momentum=0.9)
    state = opt.init(pj)
    step = jax.jit(JM.make_train_step(opt))
    ref = []
    for i in range(steps):
        images, labels = mnist_spark.collate(
            records[i * batch:(i + 1) * batch])
        pj, state, loss, _ = step(pj, state, jnp.asarray(images),
                                  jnp.asarray(labels, jnp.int32))
        ref.append(float(loss))
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)


def test_spark_fed_transformer_matches_jax_steps(engine, tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    from tensorflowonspark_tpu.models import transformer as JT

    kw = dict(vocab_size=128, dim=64, n_layers=2, n_heads=2, max_seq=32,
              dtype="float32")
    batch, steps = 4, 3
    tokens = np.random.default_rng(5).integers(
        0, kw["vocab_size"], (batch * steps, kw["max_seq"])).astype(np.int32)
    pj = JT.init(jax.random.PRNGKey(0), JT.Config(**kw))
    _train(engine, transformer_spark.main_fun, {
        "config": kw, "batch_size": batch, "device": "cpu",
        "init_params": jax.tree_util.tree_map(np.asarray, pj),
        "out_dir": str(tmp_path)}, list(tokens), steps)
    report = json.load(open(tmp_path / "transformer-rank0.json"))
    assert report["records"] == batch * steps

    cfg = JT.Config(**kw, attn_impl="reference")
    vg = jax.jit(jax.value_and_grad(lambda p, t: JT.loss_fn(p, t, cfg)))
    opt = optax.adam(1e-3)
    state = opt.init(pj)
    ref = []
    for i in range(steps):
        loss, g = vg(pj, jnp.asarray(tokens[i * batch:(i + 1) * batch]))
        upd, state = opt.update(g, state)
        pj = optax.apply_updates(pj, upd)
        ref.append(float(loss))
    np.testing.assert_allclose(report["losses"], ref, rtol=LOSS_RTOL)


def test_two_executor_gloo_mnist_end_to_end(engine, tmp_path,
                                            telemetry_dir):
    batch, steps = 32, 24
    records = mnist_spark.synthetic_records(batch * steps, seed=0)
    _train(engine, mnist_spark.main_fun, {
        "batch_size": batch, "lr": 0.05, "device": "cpu", "seed": 0,
        "out_dir": str(tmp_path)}, records, 4, n=2, master_node="chief")
    runs = [json.load(open(tmp_path / f"mnist-rank{r}.json"))
            for r in (0, 1)]
    for r in runs:
        losses = r["losses"]
        assert len(losses) == steps
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    p0, p1 = (np.load(tmp_path / f"mnist-rank{r}.npz") for r in (0, 1))
    assert sorted(p0.files) == sorted(p1.files)
    for k in p0.files:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
    # each trainer's spans, in its own JSONL file
    for r in runs:
        files = glob.glob(os.path.join(str(telemetry_dir),
                                       f"*-{r['pid']}.jsonl"))
        names = {json.loads(line)["name"] for f in files
                 for line in open(f)}
        assert {"train/step", "feed/wait"} <= names, (r["rank"], names)
