"""PyTorch port, the TFRecord-fed paths as a whole, on the CPU, against the
JAX package over the same seeded records:

- ``infeed.tfrecord_device_feed`` on ``placement="cpu"`` gives the JAX
  package's batches;
- ``mnist_data_setup`` writes its part files, which the JAX package
  reads back as the seeded set;
- ``mnist_tf`` and ``mnist_tf_ds`` (``InputMode.TENSORFLOW``) on a
  two-executor gloo engine: each step's mean loss over the ranks equals
  the JAX MNIST step (``init_params`` from ``jax.random.PRNGKey(0)``,
  ``optax.sgd(0.05, momentum=0.9)``) on the same global batch, to 1e-4
  relative (float32 both sides, sums in another order); every part file
  is read by exactly one rank; the chief's export loads in the JAX
  package and predicts as the JAX model does;
- ``resnet_imagenet_spark`` with ``--data_dir`` (batch 2 x 32x32, two
  steps, float32): the executor reads and decodes the shards through
  the engine's lineage, and the losses equal the same ``main_fun`` fed
  the same records from the driver; a JPEG payload raises.

Every wait is bounded (``reservation_timeout``, ``feed_timeout``).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tensorflowonspark_tpu import dfutil as JD  # noqa: E402
from tensorflowonspark_tpu import infeed as JI  # noqa: E402
from tensorflowonspark_tpu.models import mnist as JM  # noqa: E402
from tensorflowonspark_tpu.utils import checkpoint as JC  # noqa: E402
from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import dfutil, infeed  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    mnist_data_setup,
    mnist_tf,
    mnist_tf_ds,
    resnet_imagenet_spark,
)
from tensorflowonspark_tpu_torch.models import mnist  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 90
LOSS_RTOL = 1e-4
BATCH, STEPS, EXAMPLES = 16, 4, 256


@pytest.fixture(scope="module")
def engine():
    e = LocalEngine(2, env={"OMP_NUM_THREADS": "2"})
    yield e
    e.stop()


def test_tfrecord_device_feed_equals_jax(tmp_path):
    d = tmp_path / "tfr"
    dfutil.save_as_tfrecords([{"x": [float(i), 0.5 * i], "y": i}
                              for i in range(12)], str(d))
    dfutil.save_as_tfrecords([{"x": [float(i), 0.5 * i], "y": i}
                              for i in range(12, 21)], str(tmp_path / "b"))
    files = [str(d / "part-r-00000"), str(tmp_path / "b" / "part-r-00000")]

    def collate(b):
        return np.asarray(b["x"]), np.asarray(b["y"])

    got = list(infeed.tfrecord_device_feed(files, 8, collate=collate,
                                           placement="cpu"))
    want = list(JI.tfrecord_device_feed(files, 8, collate=collate))
    assert len(got) == len(want) == 2  # the short tail is dropped
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.device.type == "cpu"
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    tail = list(infeed.tfrecord_device_feed(files, 8, placement="cpu",
                                            drop_remainder=False))
    assert [len(b["y"]) for b in tail] == [8, 8, 5]


def test_mnist_data_setup_writes_the_seeded_set(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m",
         "tensorflowonspark_tpu_torch.examples.mnist_data_setup",
         "--output", str(tmp_path), "--num_examples", "40",
         "--num_partitions", "4"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    files = JD.part_files(str(tmp_path / "tfr"))
    assert [os.path.basename(f) for f in files] == \
        [f"part-r-{i:05d}" for i in range(4)]
    cols = JD.load_tfrecords_columnar(files)
    images, labels = mnist_data_setup.synthetic_mnist(40)
    np.testing.assert_array_equal(cols["image"], images.reshape(40, -1))
    np.testing.assert_array_equal(cols["label"], labels)
    assert len(os.listdir(tmp_path / "csv")) == 4
    csv_images, csv_labels = mnist_data_setup.load_csv_dir(
        str(tmp_path / "csv"))
    np.testing.assert_array_equal(csv_labels, labels)
    np.testing.assert_allclose(csv_images, images, atol=1 / 255)


def _jax_losses(shards, seeds):
    """The JAX MNIST step over the global batches: each step, rank r's
    ``BATCH // ranks`` records drawn as ``mnist_tf.train`` draws them
    (``np.random.default_rng(r)``), concatenated in rank order."""
    params = JM.init_params(jax.random.PRNGKey(0))
    opt = optax.sgd(0.05, momentum=0.9)
    state = opt.init(params)
    step = jax.jit(JM.make_train_step(opt))
    per = BATCH // len(shards)
    rngs = [np.random.default_rng(s) for s in seeds]
    losses = []
    for _ in range(STEPS):
        idx = [rng.integers(0, len(im), per) for rng, (im, _) in
               zip(rngs, shards)]
        images = np.concatenate([im[i] for i, (im, _) in zip(idx, shards)])
        labels = np.concatenate([lb[i] for i, (_, lb) in zip(idx, shards)])
        params, state, loss, _ = step(params, state, jnp.asarray(images),
                                      jnp.asarray(labels, jnp.int32))
        losses.append(float(loss))
    return losses, params


def _run_tf_mode(engine, main_fun, args, tmp_path):
    c = TFCluster.run(
        engine, main_fun,
        dict(args, batch_size=BATCH, lr=0.05, steps=STEPS, device="cpu",
             init_params=jax.tree_util.tree_map(
                 np.asarray, JM.init_params(jax.random.PRNGKey(0))),
             model_dir=str(tmp_path / "model"), out_dir=str(tmp_path)),
        num_executors=2, input_mode=TFCluster.InputMode.TENSORFLOW,
        master_node="chief", reservation_timeout=TIMEOUT)
    c.shutdown()
    return [json.load(open(tmp_path / f"mnist_tf-rank{r}.json"))
            for r in (0, 1)]


def test_mnist_tf_matches_jax_steps(engine, tmp_path):
    runs = _run_tf_mode(engine, mnist_tf.main_fun,
                        {"num_examples": EXAMPLES}, tmp_path)
    images, labels = mnist_data_setup.synthetic_mnist(EXAMPLES)
    shards = [(images[r::2], labels[r::2]) for r in (0, 1)]
    want, _ = _jax_losses(shards, (0, 1))
    got = np.mean([r["losses"] for r in runs], axis=0)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert {r["pid"] for r in runs}.isdisjoint({os.getpid()})
    assert [r["records"] for r in runs] == [EXAMPLES // 2] * 2


def test_mnist_tf_ds_reads_each_part_once_and_matches_jax(engine, tmp_path):
    images, labels = mnist_data_setup.synthetic_mnist(EXAMPLES)
    _, tfr = mnist_data_setup.write_shards(images, labels,
                                           str(tmp_path / "data"), 4)
    runs = _run_tf_mode(engine, mnist_tf_ds.main_fun, {"data_dir": tfr},
                        tmp_path)
    files = [f for r in runs for f in r["files"]]
    assert sorted(files) == [f"part-r-{i:05d}" for i in range(4)]
    assert runs[0]["files"] == ["part-r-00000", "part-r-00002"]
    per = EXAMPLES // 4
    shards = [(np.concatenate([images[p * per:(p + 1) * per]
                               for p in parts]),
               np.concatenate([labels[p * per:(p + 1) * per]
                               for p in parts]))
              for parts in ((0, 2), (1, 3))]
    want, jparams = _jax_losses(shards, (0, 1))
    got = np.mean([r["losses"] for r in runs], axis=0)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)

    # the chief's export: the JAX package loads it, and both packages'
    # predict signatures give the JAX model's logits
    params, meta = JC.load_exported(str(tmp_path / "model" / "export"))
    assert meta == {"format": "tfos-tpu-export-v1",
                    "predict": mnist.PREDICT}
    probe = {"image": images[:8].reshape(8, -1)}
    ref = JM.predict(jparams, probe)
    for p in (params, jax.tree_util.tree_map(np.asarray, jparams)):
        out = mnist.predict(p, probe, device="cpu")
        np.testing.assert_allclose(out["logits"], np.asarray(ref["logits"]),
                                   rtol=1e-3, atol=1e-4)


class _RankCtx:
    """Just enough of a node context for ``mnist_tf_ds.main_fun``."""

    def __init__(self, rank, nproc):
        self.env = {"process_id": rank, "num_processes": nproc,
                    "device": torch.device("cpu")}

    def torch_initialize(self, device=None):
        return self.env

    def absolute_path(self, path):
        return "file://" + path


def test_mnist_tf_ds_raises_for_a_rank_without_data(tmp_path):
    images, labels = mnist_data_setup.synthetic_mnist(8)
    _, tfr = mnist_data_setup.write_shards(images, labels,
                                           str(tmp_path / "data"), 1)
    with pytest.raises(RuntimeError, match="rank 1/2 got no data"):
        mnist_tf_ds.main_fun({"data_dir": tfr}, _RankCtx(1, 2))


@pytest.fixture(scope="module")
def engine1():
    e = LocalEngine(1, env={"OMP_NUM_THREADS": "2"})
    yield e
    e.stop()


def _resnet_run(engine, ds, tmp_path, name):
    out = tmp_path / name
    out.mkdir()
    c = TFCluster.run(
        engine, resnet_imagenet_spark.main_fun,
        {"batch_size": 2, "lr": 0.1, "image_size": 32, "num_classes": 10,
         "model_dir": str(out / "model"), "device": "cpu",
         "compute_dtype": "float32", "out_dir": str(out)},
        num_executors=1, input_mode=TFCluster.InputMode.SPARK,
        reservation_timeout=TIMEOUT)
    c.train(ds, feed_timeout=TIMEOUT)
    assert c.server.fed_partitions("input") == list(range(ds.num_partitions))
    c.shutdown()
    return json.load(open(out / "resnet_imagenet-rank0.json"))


def test_resnet_data_dir_matches_driver_fed_records(engine1, tmp_path):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    labels = [3, 1, 4, 1]
    d = tmp_path / "tfr"
    d.mkdir()
    for s in range(2):  # two shards of one step each
        dfutil._write_shard([{"image": images[i].tobytes(),
                              "label": labels[i]}
                             for i in (2 * s, 2 * s + 1)],
                            str(d / f"part-r-{s:05d}"))
    args = argparse.Namespace(data_dir=str(d), cluster_size=1,
                              image_size=32, batch_size=2, steps=2,
                              num_classes=10)
    ds = resnet_imagenet_spark._records(args, engine1)
    from_files = _resnet_run(engine1, ds, tmp_path, "tfr_run")
    # the tasks carried file names, not images
    assert engine1.last_dispatch["max_bytes"] < 4096
    assert [len(f["lineage_ms"]) for f in from_files["feeders"]] == [2, 2]
    from_driver = _resnet_run(
        engine1, engine1.parallelize(
            [(images[i], labels[i]) for i in range(4)], 2),
        tmp_path, "driver_run")
    assert len(from_files["losses"]) == 2
    np.testing.assert_allclose(from_files["losses"], from_driver["losses"],
                               rtol=1e-6)
    # a JPEG payload of exactly 32x32x3 bytes is decoded as a JPEG (and
    # this corrupt one raises), never read as pixels
    with pytest.raises(ValueError, match="JPEG"):
        list(resnet_imagenet_spark.decode_stream(32)(
            iter([{"image": b"\xff\xd8" + bytes(3070), "label": 0}])))
