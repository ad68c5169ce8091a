"""PyTorch port, ``utils/checkpoint.py`` and the SPARK-fed ResNet, against
the JAX package (CPU, float32):

- a checkpoint the JAX package writes (params, BN state and
  ``pack_pytree`` of the ``optax.sgd(0.1, momentum=0.9)`` state)
  restores in the port bit for bit (conv kernels HWIO -> OIHW, the
  momentum buffers from optax's ``trace``), and the next step's loss
  equals JAX's next step; the other way round the same;
- ``restore_latest`` skips a torn npz and a tombstoned or
  digest-mismatched step (manifests written by the JAX package);
- ``save_checkpoint`` keeps the newest three and leaves no tmp file;
  remote URLs raise;
- the serving reload's ``latest``, ``latest_step``, ``restore_step`` and
  ``restore_any`` (``blessed_only``, torn steps) agree with the JAX
  package's on checkpoints either package wrote; orbax steps are listed
  and not restored;
- the port's ``resnet_cifar_spark.main_fun`` at depth 20 on one executor
  starts from a JAX-written checkpoint, and its losses equal the JAX
  package's in-process steps over the same batches; a second run resumes
  from the checkpoint the first one's chief saved and continues at its
  step, with JAX's losses again.

Losses to 1e-4 relative (``LOSS_RTOL``): both sides compute in float32
and differ by summation order, which SGD carries from step to step.
Every wait is bounded (``reservation_timeout``, ``feed_timeout``).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tensorflowonspark_tpu.models import resnet as JR  # noqa: E402
from tensorflowonspark_tpu.utils import checkpoint as JC  # noqa: E402
from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    resnet_cifar_spark,
)
from tensorflowonspark_tpu_torch.models import resnet as R  # noqa: E402
from tensorflowonspark_tpu_torch.utils import checkpoint as C  # noqa: E402
from tensorflowonspark_tpu_torch.utils import train as TU  # noqa: E402

TIMEOUT = 90
LOSS_RTOL = 1e-4
DEPTH, WIDTH, BATCH = 20, 16, 8


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's CIFAR ResNet-20 (width 16) from its init, the
    jitted ``optax.sgd(0.1, momentum=0.9)`` step, and 4 batches of the
    example's synthetic records."""
    pj, sj = jax.jit(lambda k: JR.init(k, depth=DEPTH, num_classes=10,
                                       width=WIDTH, small_inputs=True))(
        jax.random.PRNGKey(0))
    opt = optax.sgd(0.1, momentum=0.9)
    step = jax.jit(JR.make_train_step(opt, depth=DEPTH, small_inputs=True,
                                      compute_dtype=jnp.float32))
    records = resnet_cifar_spark.synthetic_records(4 * BATCH)
    batches = [resnet_cifar_spark.collate(records[i:i + BATCH])
               for i in range(0, len(records), BATCH)]
    return pj, sj, opt, step, records, batches


def _jax_steps(jax_run, n, start=None):
    """n JAX steps from ``start`` = (params, state, opt_state) (default
    the init) over the batches after ``start``'s; returns the losses and
    the end (params, state, opt_state)."""
    pj, sj, opt, step, _, batches = jax_run
    p, s, o = start or (pj, sj, opt.init(pj))
    losses = []
    for images, labels in batches[:n]:
        p, s, o, loss, _ = step(p, s, o, jnp.asarray(images),
                                jnp.asarray(labels, jnp.int32))
        losses.append(float(loss))
    return losses, (p, s, o)


def _port_net():
    params, state = R.init(torch.Generator().manual_seed(7), depth=DEPTH,
                           num_classes=10, width=WIDTH, small_inputs=True)
    leaves = [p.requires_grad_() for p in R.param_leaves(params)]
    opt = torch.optim.SGD(leaves, lr=0.1, momentum=0.9)
    step = R.make_train_step(opt, depth=DEPTH, small_inputs=True,
                             compute_dtype=torch.float32)
    return params, state, opt, step


def _port_step(net, images, labels):
    params, state, opt, step = net
    loss, _, state = step(params, state, torch.from_numpy(images),
                          torch.from_numpy(labels))
    return float(loss), (params, state, opt, step)


def test_jax_checkpoint_restores_in_the_port_and_continues(jax_run,
                                                           tmp_path):
    (jl,), (p1, s1, o1) = _jax_steps(jax_run, 1)
    JC.save_checkpoint(str(tmp_path), {"params": p1, "state": s1,
                                       "opt": JC.pack_pytree(o1)}, 1)
    tree, step = C.restore_latest(str(tmp_path))
    assert step == 1 and set(tree) == {"params", "state", "opt"}
    net = _port_net()
    params, state, opt, _ = net
    R.restore_checkpoint_tree(tree, params, state, opt)
    # bit for bit: params, state and the momentum buffers (optax's trace)
    got_p, got_s = R.params_to_jax(params, state)
    got_m, _ = R.params_to_jax(TU.sgd_momentum_tree(opt, params))
    trace = o1[0].trace
    for a, b in zip(C.tree_leaves(got_p) + C.tree_leaves(got_s)
                    + C.tree_leaves(got_m),
                    C.tree_leaves(p1) + C.tree_leaves(s1)
                    + C.tree_leaves(trace)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert np.abs(C.tree_leaves(got_m)[0]).max() > 0
    (ref,), _ = _jax_steps((*jax_run[:5], jax_run[5][1:]), 1,
                           start=(p1, s1, o1))
    got, _ = _port_step(net, *jax_run[5][1])
    assert abs(got - ref) <= LOSS_RTOL * abs(ref), (got, ref)


def test_port_checkpoint_restores_in_jax_and_continues(jax_run, tmp_path):
    pj, sj, opt, step, _, batches = jax_run
    net = _port_net()
    params, state, sgd, _ = net
    R.restore_checkpoint_tree(
        {"params": pj, "state": sj, "opt": JC.pack_pytree(opt.init(pj))},
        params, state, sgd)
    _, net = _port_step(net, *batches[0])
    params, state, sgd, _ = net
    path = C.save_checkpoint(str(tmp_path),
                             R.checkpoint_tree(params, state, sgd), 1)
    assert C.step_of(path) == 1
    tree, jstep = JC.restore_latest(str(tmp_path))
    assert jstep == 1
    assert tree["params"]["stem"]["w"].shape == (3, 3, 3, WIDTH)  # HWIO
    o1 = JC.unpack_pytree(tree["opt"], opt.init(pj))
    want_p, want_s = R.params_to_jax(params, state)
    for a, b in zip(C.tree_leaves(tree["params"])
                    + C.tree_leaves(tree["state"]),
                    C.tree_leaves(want_p) + C.tree_leaves(want_s)):
        np.testing.assert_array_equal(a, b)
    want_m, _ = R.params_to_jax(TU.sgd_momentum_tree(sgd, params))
    for a, b in zip(jax.tree_util.tree_leaves(o1),
                    C.tree_leaves(want_m)):
        np.testing.assert_array_equal(np.asarray(a), b)
    _, _, _, ref, _ = step(tree["params"], tree["state"], o1,
                           jnp.asarray(batches[1][0]),
                           jnp.asarray(batches[1][1], jnp.int32))
    got, _ = _port_step(net, *batches[1])
    assert abs(got - float(ref)) <= LOSS_RTOL * abs(float(ref))


def test_pack_pytree_matches_jax_order():
    """The port's packing of a momentum tree gives the keys and arrays of
    the JAX package's packing of the optax.sgd state."""
    rng = np.random.default_rng(0)

    def leaf(n):
        return rng.random(n, dtype=np.float32)

    tree = {"b": {"w": leaf(3), "b": leaf(2)}, "a": leaf(4),
            "c": {"x": {"y": leaf(1)}}}
    jstate = (optax.TraceState(trace=jax.tree_util.tree_map(jnp.asarray,
                                                           tree)),
              optax.EmptyState())
    want = JC.pack_pytree(jstate)
    got = C.pack_pytree(tree)
    assert list(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    back = C.unpack_pytree(got, tree)
    for a, b in zip(C.tree_leaves(back), C.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def _tree(v):
    return {"params": {"w": np.full((2, 3), v, np.float32)},
            "opt": {"00000": np.arange(3.0) + v}}


def test_restore_skips_torn_tombstoned_and_mismatched_steps(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        C.save_checkpoint(d, _tree(s), s, keep=10)
    JC.bless_checkpoint(d, 1, score=0.5)
    # step 4 torn: half its bytes
    p4 = os.path.join(d, "ckpt-00000004.npz")
    with open(p4, "rb") as f:
        blob = f.read()
    with open(p4, "wb") as f:
        f.write(blob[:len(blob) // 2])
    JC.tombstone_checkpoint(d, 3, "regressed in canary")
    # step 2 blessed, then its bytes change under the manifest
    JC.bless_checkpoint(d, 2)
    p2 = os.path.join(d, "ckpt-00000002.npz")
    C.save_checkpoint(d, _tree(20), 2, keep=10)
    assert C.verify_manifest(d, 2)[0] is False
    assert C.verify_manifest(d, 3) == (False, "tombstoned (regressed in "
                                              "canary)")
    assert C.verify_manifest(d, 1) == (True, "ok")
    tree, step = C.restore_latest(d)
    assert step == 1
    np.testing.assert_array_equal(tree["params"]["w"], _tree(1)["params"]["w"])
    assert C.latest_checkpoint(d) == os.path.join(d, "ckpt-00000001.npz")
    assert JC.restore_latest(d)[1] == 1  # the JAX package agrees
    assert os.path.exists(p2)


def test_save_keeps_the_newest_and_reads_in_jax(tmp_path):
    d = str(tmp_path / "ckpt")
    assert C.restore_latest(d) == (None, 0)
    for s in range(1, 6):
        C.save_checkpoint(d, {"params": {"w": torch.full((2,), float(s))}},
                          s)
    names = sorted(os.listdir(d))
    assert names == [f"ckpt-{s:08d}.npz" for s in (3, 4, 5)]
    tree = JC.load_checkpoint(os.path.join(d, names[-1]))
    np.testing.assert_array_equal(tree["params"]["w"], [5.0, 5.0])
    assert C.restore_latest("file://" + d)[1] == 5
    # a remote URL goes through fsspec: the same pruning, and the JAX
    # package reads it back
    url = f"memory://ckpt-keep-{os.getpid()}"
    for s in range(1, 6):
        C.save_checkpoint(url, {"params": {"w": torch.full((2,), float(s))}},
                          s)
    assert sorted(C._fs.listdir(url)) == names
    for mod in (C, JC):
        tree, step = mod.restore_latest(url)
        assert step == 5
        np.testing.assert_array_equal(tree["params"]["w"], [5.0, 5.0])


def _same_tree(a, b):
    assert sorted(C._flatten(a)) == sorted(C._flatten(b))
    for k, v in C._flatten(a).items():
        np.testing.assert_array_equal(v, C._flatten(b)[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_latest_restore_step_and_restore_any_across_packages(writer,
                                                             tmp_path):
    """The serving reload's listing and restores: checkpoints written by
    either package give the same ``latest``/``latest_step`` and restore
    the same trees through ``restore_step``/``restore_any`` in both,
    ``blessed_only`` and a torn newest step included."""
    d = str(tmp_path / "ckpt")
    save = JC.save_checkpoint if writer == "jax" else C.save_checkpoint
    assert C.latest(d) == (None, None) and C.latest_step(d) is None
    assert C.restore_any(d) == (None, 0)
    for s in (1, 2, 3):
        save(d, _tree(s), s)
    for mod in (C, JC):
        step, path = mod.latest(d)
        assert (step, os.path.basename(path)) == (3, "ckpt-00000003.npz")
        assert mod.latest_step(d) == 3
        _same_tree(mod.restore_step(d, 2), _tree(2))
        tree, step = mod.restore_any(d)
        assert step == 3
        _same_tree(tree, _tree(3))
    with pytest.raises(FileNotFoundError):
        C.restore_step(d, 7)
    JC.bless_checkpoint(d, 1)
    p3 = os.path.join(d, "ckpt-00000003.npz")
    with open(p3, "rb") as f:
        blob = f.read()
    with open(p3, "wb") as f:
        f.write(blob[:len(blob) // 2])
    for mod in (C, JC):
        assert mod.restore_any(d)[1] == 2          # the torn 3 skipped
        tree, step = mod.restore_any(d, blessed_only=True)
        assert step == 1
        _same_tree(tree, _tree(1))


def test_orbax_steps_are_listed_and_not_restored(tmp_path):
    """An orbax step directory (the JAX package's ``AsyncCheckpointer``)
    is the newest in ``latest``, as in the JAX package; the port's
    restores skip it or raise, saying why (by design: orbax imports
    JAX)."""
    d = str(tmp_path)
    C.save_checkpoint(d, _tree(1), 1)
    os.makedirs(os.path.join(d, "5"))
    assert C.latest(d) == (5, os.path.join(d, "5"))
    assert C.latest(d)[0] == JC.latest(d)[0] == C.latest_step(d) == 5
    tree, step = C.restore_any(d)
    assert step == 1
    _same_tree(tree, _tree(1))
    with pytest.raises(NotImplementedError, match="npz checkpoints only"):
        C.restore_step(d, 5)
    # a placed restore skips the orbax step as well, and places step 1
    _placed_restore_is_step(d, 1, tmp_path)


def _placed_restore_is_step(d, step, tmp_path):
    """``restore_any(target_shardings=)`` in a one-process gloo group:
    DTensor leaves on a one-rank mesh whose values are the step's."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from tensorflowonspark_tpu_torch.parallel import fsdp_sharding, make_mesh
    from tensorflowonspark_tpu_torch.parallel.sharding import local_tree

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "pg"), 1), rank=0,
        world_size=1)
    try:
        mesh = make_mesh({"data": 1}, device_type="cpu")
        tree, got = C.restore_any(
            d, target_shardings=lambda t: fsdp_sharding(mesh, t))
        assert got == step
        assert all(isinstance(x, DTensor)
                   for x in C.tree_leaves(tree))
        _same_tree(local_tree(tree), _tree(step))
    finally:
        dist.destroy_process_group()


# -- the SPARK-fed ResNet ----------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    e = LocalEngine(1, env={"OMP_NUM_THREADS": "2"})
    yield e
    e.stop()


def _spark_run(engine, records, model_dir, out_dir):
    c = TFCluster.run(engine, resnet_cifar_spark.main_fun, {
        "batch_size": BATCH, "lr": 0.1, "depth": DEPTH,
        "model_dir": str(model_dir), "device": "cpu",
        "compute_dtype": "float32", "out_dir": str(out_dir)},
        num_executors=1, input_mode=TFCluster.InputMode.SPARK,
        reservation_timeout=TIMEOUT)
    n = len(records) // BATCH
    c.train(engine.parallelize(records, n), feed_timeout=TIMEOUT)
    assert c.server.fed_partitions("input") == list(range(n))
    c.shutdown()
    with open(os.path.join(out_dir, "resnet_cifar-rank0.json")) as f:
        return json.load(f)


def test_spark_fed_resnet_matches_jax_and_resumes(engine, jax_run, tmp_path):
    """Two runs of two steps.  The training trajectory is sensitive: over
    four steps float32 summation order alone moves the loss by ~1e-3
    (the JAX package jitted against eager: 2.3e-4 at step 4 of
    lr 0.01; the port in float32 against float64: 8e-4), so each run is
    held to JAX's steps from the same start: the first from the JAX
    package's init, the second from the checkpoint the first run's chief
    saved, which the JAX package restores too."""
    pj, sj, opt, step, records, batches = jax_run
    ckpt_dir = str(tmp_path / "model" / "ckpt")
    # the first run starts from the JAX package's init, written as step 0
    JC.save_checkpoint(ckpt_dir, {"params": pj, "state": sj,
                                  "opt": JC.pack_pytree(opt.init(pj))}, 0)
    ref, _ = _jax_steps(jax_run, 2)
    first = _spark_run(engine, records[:2 * BATCH], tmp_path / "model",
                       tmp_path)
    assert (first["start_step"], first["step"]) == (0, 2)
    np.testing.assert_allclose(first["losses"], ref, rtol=LOSS_RTOL)

    tree, saved = JC.restore_latest(ckpt_dir)
    assert saved == 2
    start = (tree["params"], tree["state"],
             JC.unpack_pytree(tree["opt"], opt.init(pj)))
    ref2, _ = _jax_steps((*jax_run[:5], batches[2:]), 2, start=start)
    second = _spark_run(engine, records[2 * BATCH:4 * BATCH],
                        tmp_path / "model", tmp_path)
    assert (second["start_step"], second["step"]) == (2, 4)
    np.testing.assert_allclose(second["losses"], ref2, rtol=LOSS_RTOL)
    assert C.restore_latest(ckpt_dir)[1] == 4
