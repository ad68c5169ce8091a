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
- the transformer's checkpoints and export (``ckpt_dir``,
  ``export_dir``): the JAX package loads the export as the params of the
  same steps taken in process;
- MNIST's chief checkpoint (``model_dir/ckpt``, the step count) and
  export: the JAX package's ``restore_latest`` reads the checkpoint as
  the export's params, which are the trainer's own;
- MNIST on two executors over a gloo group, mirroring
  tests/test_mnist_e2e.py without the export: the loss falls, both
  ranks end with equal params, and the trainers' ``train/step`` and
  ``feed/wait`` spans reach the telemetry directory.

Every wait is bounded (``reservation_timeout``, ``feed_timeout``).
"""

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

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


def test_spark_fed_mnist_chief_checkpoint_restores_in_jax(engine, tmp_path):
    from tensorflowonspark_tpu.utils import checkpoint as JC
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    batch, steps = 16, 4
    records = mnist_spark.synthetic_records(batch * steps, seed=7)
    model_dir = tmp_path / "model"
    _train(engine, mnist_spark.main_fun, {
        "batch_size": batch, "lr": 0.05, "device": "cpu", "seed": 1,
        "model_dir": str(model_dir), "out_dir": str(tmp_path)}, records, 2)
    tree, step = JC.restore_latest(str(model_dir / "ckpt"))
    assert step == steps
    assert os.listdir(model_dir / "ckpt") == [f"ckpt-{steps:08d}.npz"]
    exported, meta = JC.load_exported(str(model_dir / "export"))
    assert meta["predict"] == "tensorflowonspark_tpu_torch.models.mnist:predict"
    got, want = ckpt._flatten(tree), ckpt._flatten(exported)
    assert sorted(got) == sorted(want) and tree["conv1"]["w"].ndim == 4
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    final = np.load(tmp_path / "mnist-rank0.npz")
    np.testing.assert_array_equal(  # HWIO on disk, OIHW in the trainer
        tree["conv1"]["w"], final["conv1.w"].transpose(2, 3, 1, 0))
    np.testing.assert_array_equal(tree["fc2"]["b"], final["fc2.b"])


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


def test_spark_fed_transformer_checkpoints_and_exports(engine, tmp_path):
    """``--ckpt_dir``/``--export_dir``: the chief checkpoints the params
    and Adam's state every ``ckpt_every`` steps and at the end, and
    exports with the ``Config``
    in the metadata; the JAX package's ``load_exported`` reads the
    export as the trained params: those of the same Adam steps taken in
    this process from the same init over the same batches (float32, to
    1e-5 relative; the trainer's and this process's steps run the same
    ops in the same order)."""
    import dataclasses

    import jax

    from tensorflowonspark_tpu.models import transformer as JT
    from tensorflowonspark_tpu.utils import checkpoint as JC
    from tensorflowonspark_tpu_torch.models import transformer as TT
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    kw = dict(vocab_size=128, dim=64, n_layers=2, n_heads=2, max_seq=32,
              dtype="float32")
    batch, steps = 4, 3
    tokens = np.random.default_rng(6).integers(
        0, kw["vocab_size"], (batch * steps, kw["max_seq"])).astype(np.int32)
    init = jax.tree_util.tree_map(
        np.asarray, JT.init(jax.random.PRNGKey(1), JT.Config(**kw)))
    ckpt_dir, export_dir = str(tmp_path / "ckpt"), str(tmp_path / "export")
    _train(engine, transformer_spark.main_fun, {
        "config": kw, "batch_size": batch, "device": "cpu",
        "init_params": init, "ckpt_dir": ckpt_dir, "ckpt_every": 2,
        "export_dir": export_dir}, list(tokens), steps)
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt-00000002.npz",
                                            "ckpt-00000003.npz"]
    exported, meta = JC.load_exported(export_dir)
    cfg = TT.Config(**kw)
    assert meta["config"] == dataclasses.asdict(cfg)
    params = TT.params_from_jax(init, cfg, device="cpu")
    leaves = [params["embed"], params["ln_f"], params["head"],
              *params["layers"].values()]
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for i in range(steps):
        loss = TT.loss_fn(params, torch.from_numpy(
            tokens[i * batch:(i + 1) * batch].astype(np.int64)), cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    want = ckpt._flatten(params)
    got = ckpt._flatten(exported)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    last_tree = ckpt.load_checkpoint(
        os.path.join(ckpt_dir, "ckpt-00000003.npz"))
    last = ckpt._flatten(last_tree["params"])
    for k in want:
        np.testing.assert_array_equal(last[k], got[k], err_msg=k)
    # Adam's (count, mu, nu) beside the params, packed as the JAX
    # package packs optax.adam's state: the count, then each moment tree
    # in sorted-key order
    opt_leaves = [last_tree["opt"][k] for k in sorted(last_tree["opt"])]
    assert int(opt_leaves[0]) == steps
    order = ckpt.tree_leaves(params)
    assert len(opt_leaves) == 1 + 2 * len(order)
    for i, p in enumerate(order):
        st = opt.state[p]
        np.testing.assert_allclose(opt_leaves[1 + i], st["exp_avg"].numpy(),
                                   rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(opt_leaves[1 + len(order) + i],
                                   st["exp_avg_sq"].numpy(), rtol=1e-5,
                                   atol=1e-12)


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
    # each trainer's spans, in its own JSONL file of its node's spool
    for r in runs:
        files = glob.glob(os.path.join(str(telemetry_dir), "spool-*",
                                       f"*-{r['pid']}.jsonl"))
        names = {json.loads(line)["name"] for f in files
                 for line in open(f)}
        assert {"train/step", "feed/wait"} <= names, (r["rank"], names)
