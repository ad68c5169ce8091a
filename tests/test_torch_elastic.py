"""PyTorch port, the elastic runtime, on the CPU, held against the JAX
package's ``elastic`` and against the port's own flat gradients:

- ``virtualize`` gives the JAX package's ``n_virtual``, ``accum_steps``,
  logical and physical axes and microbatch schedule on the same device
  counts (the JAX side on the ``eight_devices`` fixture), with the same
  rejections; ``ElasticRuntime.batch_schedule`` and ``resize`` match;
- the accum-2 gradient of the small transformer through the layout's
  ``value_and_grad`` equals the JAX layout's and the port's flat one,
  to 1e-5 relative;
- on two gloo ranks (``RankPool``): each rank's half of the batch under
  a ``{"data": 2}`` mesh folded from a logical ``{"data": 4}`` (accum 2)
  gives the flat full-batch loss and gradient, and ``restore`` places a
  checkpoint by the fsdp rules of a ``{"fsdp": 2}`` layout;
- one process: ``reshard``, ``reshard_train_state`` and ``restore`` on
  a layout with no mesh place the values unchanged on its device;
- end to end on a 2-executor ``LocalEngine`` (gloo, the tiny
  transformer with ``elastic_data=2``): executor 1 SIGKILLed at its 7th
  put (its trainer has then finished two steps, the second after the
  chief saved the first) with no
  respawn budget and ``run(restarts=1, min_executors=1)`` shrinks the
  cluster to ``{"worker": [0]}``: epoch 0 ran at world 2 with accum 1,
  epoch 1 at world 1 with accum 2, the ledger holds every partition
  once, the first resumed step's loss equals an accum-2 replay from the
  restored checkpoint, every resumed step's loss equals the JAX
  package's full-batch optax step from the checkpoint's params and Adam
  state, and ``cluster/resize``, ``rendezvous/resize`` and
  ``elastic/from_context`` are on disk.
"""

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import elastic  # noqa: E402
from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    transformer_spark,
)
from tensorflowonspark_tpu_torch.parallel.launch import (  # noqa: E402
    RankPool,
)
from tensorflowonspark_tpu_torch.utils import (  # noqa: E402
    checkpoint as ckpt,
    telemetry,
)

pytestmark = pytest.mark.elastic

TIMEOUT = 90
TINY = dict(vocab_size=64, dim=32, n_layers=1, n_heads=2, max_seq=16,
            dtype="float32")


# -- the algebra --------------------------------------------------------------

LAYOUTS = [
    ({"data": 4, "fsdp": 2}, 8, "data", 64),   # identity fold
    ({"data": 8, "fsdp": 2}, 8, "data", 64),   # 2x into data
    ({"data": 8}, 2, "data", 64),              # 4x
    ({"data": 8}, 1, "data", 64),
    ({"pipe": 2, "expert": 4}, 8, "data", 8),  # aliases, no fold
    ({"data": 2, "fsdp": 4}, 4, "fsdp", 16),   # another accum axis
    ({"data": 8}, 3, "data", 64),              # not a divisor
    ({"data": 2, "fsdp": 4}, 2, "data", 64),   # fold does not divide
    ({"fsdp": 8}, 4, "data", 64),              # no accum axis
    ({"data": -1}, 8, "data", 64),             # -1 refused
    ({"data": 0}, 8, "data", 64),              # sizes >= 1
    ({"data": 8}, 4, "data", 6),               # batch not divisible
]


def _algebra(layout, global_batch):
    try:
        micro = layout.microbatch(global_batch)
    except ValueError:
        micro = "raises"
    return dict(logical=dict(layout.logical), physical=dict(layout.physical),
                accum_axis=layout.accum_axis, accum=layout.accum_steps,
                n_virtual=layout.n_virtual, n_physical=layout.n_physical,
                micro=micro)


@pytest.mark.parametrize("logical,n,accum_axis,batch", LAYOUTS,
                         ids=[f"case{i}" for i in range(len(LAYOUTS))])
def test_virtualize_matches_jax(eight_devices, logical, n, accum_axis,
                                batch):
    from tensorflowonspark_tpu.elastic import virtualize as jvirtualize

    def run(fn, devices):
        try:
            return _algebra(fn(logical, devices, accum_axis=accum_axis),
                            batch)
        except ValueError:
            return "raises"

    want = run(jvirtualize, eight_devices[:n])
    got = run(elastic.virtualize, ["cpu"] * n)
    assert got == want


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_runtime_schedule_and_resize_match_jax(eight_devices, n):
    from tensorflowonspark_tpu import elastic as JE

    spec = dict(mesh_axes={"data": 8}, global_batch=64)
    jrt = JE.ElasticRuntime(JE.TrainSpec(**spec), eight_devices)
    rt = elastic.ElasticRuntime(elastic.TrainSpec(**spec), ["cpu"] * 8)
    assert rt.batch_schedule() == jrt.batch_schedule()
    jrt.resize(eight_devices[:n])
    rt.resize(["cpu"] * n)
    assert rt.generation == jrt.generation == 1
    assert rt.batch_schedule() == jrt.batch_schedule()
    assert rt.layout.physical == jrt.layout.physical
    with pytest.raises(ValueError):
        elastic.ElasticRuntime(elastic.TrainSpec({"data": 8}),
                               ["cpu"]).batch_schedule()


# -- the accumulated gradient -------------------------------------------------

def _tiny(seed=0, batch=8):
    import jax

    from tensorflowonspark_tpu.models import transformer as JT

    pj = jax.tree_util.tree_map(np.asarray, JT.init(
        jax.random.PRNGKey(seed), JT.Config(**TINY)))
    tokens = np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (batch, TINY["max_seq"])).astype(np.int32)
    return pj, tokens


def test_accum2_gradient_matches_jax_layout_and_flat(eight_devices):
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.elastic import virtualize as jvirtualize
    from tensorflowonspark_tpu.models import transformer as JT
    from tensorflowonspark_tpu_torch.models import transformer as T
    from tensorflowonspark_tpu_torch.utils import train

    pj, tokens = _tiny()
    jcfg = JT.Config(**TINY, attn_impl="reference")
    jlayout = jvirtualize({"data": 8}, eight_devices[:4])
    assert jlayout.accum_steps == 2
    jloss, jgrads = jax.jit(jlayout.value_and_grad(
        lambda p, t: JT.loss_fn(p, t, jcfg)))(pj, jnp.asarray(tokens))

    cfg = T.Config(**TINY)
    layout = elastic.virtualize({"data": 8}, ["cpu"] * 4)
    assert layout.accum_steps == 2 and layout.mesh is None
    params = T.params_from_jax(pj, cfg, device="cpu")
    transformer_spark.make_optimizer(params)
    batch = torch.from_numpy(tokens.astype(np.int64))
    loss, grads = layout.value_and_grad(
        transformer_spark.elastic_loss(cfg))(params, batch)
    # the gradients are the leaves' .grad, for the optimizer
    assert all(g is p.grad for g, p in zip(
        ckpt.tree_leaves(grads), ckpt.tree_leaves(params)))
    flat_loss, flat_grads = train.value_and_grad(
        lambda p, t: T.loss_fn(p, t, cfg))(params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(flat_loss), rtol=1e-5)
    want = ckpt._flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    got, flat = ckpt._flatten(grads), ckpt._flatten(flat_grads)
    assert sorted(got) == sorted(want) == sorted(flat)
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=k)
        np.testing.assert_allclose(got[k], flat[k], rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=k)


# -- two ranks ----------------------------------------------------------------

@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


def rank_accum_step(pj, tokens):
    """This rank's half of ``tokens`` under a logical data=4 mesh on two
    ranks (accum 2): loss and gradients, and the layout."""
    from tensorflowonspark_tpu_torch.models import transformer as T

    import torch.distributed as dist

    cfg = T.Config(**TINY)
    rt = elastic.ElasticRuntime(elastic.TrainSpec({"data": 4},
                                                  global_batch=len(tokens)),
                                ["cpu"] * dist.get_world_size())
    params = T.params_from_jax(pj, cfg, device="cpu")
    transformer_spark.make_optimizer(params)
    half = len(tokens) // 2
    mine = tokens[dist.get_rank() * half:(dist.get_rank() + 1) * half]
    loss, grads = rt.value_and_grad(transformer_spark.elastic_loss(cfg))(
        params, torch.from_numpy(mine.astype(np.int64)))
    return (float(loss), ckpt._flatten(grads), rt.batch_schedule(),
            dict(rt.layout.physical), rt.layout.accum_steps)


def rank_restore(d):
    import torch.distributed as dist

    rt = elastic.ElasticRuntime(elastic.TrainSpec({"fsdp": 2}),
                                ["cpu"] * dist.get_world_size())
    tree, step = rt.restore(d)
    return step, {k: v.to_local().numpy() for k, v in
                  ckpt._flatten_leaves(tree)}


def test_two_ranks_accumulate_to_the_flat_gradient(pool):
    from tensorflowonspark_tpu_torch.models import transformer as T
    from tensorflowonspark_tpu_torch.utils import train

    pj, tokens = _tiny(seed=1)
    cfg = T.Config(**TINY)
    params = T.params_from_jax(pj, cfg, device="cpu")
    flat_loss, flat = train.value_and_grad(
        lambda p, t: T.loss_fn(p, t, cfg))(
        params, torch.from_numpy(tokens.astype(np.int64)))
    flat = ckpt._flatten(flat)
    for loss, grads, sched, physical, accum in pool.run(
            rank_accum_step, pj, tokens, timeout=TIMEOUT):
        assert physical == {"data": 2} and accum == 2
        assert sched == {"global": 8, "microbatch": 4, "per_device": 2,
                         "accum_steps": 2}
        np.testing.assert_allclose(loss, float(flat_loss), rtol=1e-5)
        for k in flat:
            np.testing.assert_allclose(grads[k], flat[k], rtol=1e-5,
                                       atol=1e-6 * np.abs(flat[k]).max(),
                                       err_msg=k)


def test_restore_places_by_the_layouts_fsdp_rules(pool, tmp_path):
    d = str(tmp_path)
    big = np.arange(128 * 64, dtype=np.float32).reshape(128, 64)
    ckpt.save_checkpoint(d, {"params": {"big": big,
                                        "tiny": np.ones(4, np.float32)}}, 4)
    ranks = pool.run(rank_restore, d, timeout=TIMEOUT)
    for r, (step, leaves) in enumerate(ranks):
        assert step == 4
        np.testing.assert_array_equal(leaves["params/big"],
                                      big[r * 64:(r + 1) * 64])
        np.testing.assert_array_equal(leaves["params/tiny"], np.ones(4))


# -- one process --------------------------------------------------------------

def test_reshard_without_a_mesh_keeps_values(tmp_path):
    rt = elastic.ElasticRuntime(elastic.TrainSpec({"data": 2}), ["cpu"])
    assert rt.layout.accum_steps == 2 and rt.mesh is None
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": np.ones(3)}
    placed = rt.reshard(tree)
    assert placed["w"] is not tree["w"]
    np.testing.assert_array_equal(placed["w"].numpy(), tree["w"].numpy())
    assert elastic.host_fetch(placed)["b"].tolist() == [1.0] * 3
    (p, s, o), shardings = rt.reshard_train_state(
        {"w": tree["w"]}, {"bn": np.zeros(2)}, {"mu": np.ones(2)})
    assert p["w"].requires_grad and p["w"].device.type == "cpu"
    assert shardings == (rt.layout.device,) * 3
    np.testing.assert_array_equal(o["mu"].numpy(), np.ones(2))
    ckpt.save_checkpoint(str(tmp_path), {"params": {"w": np.eye(2)}}, 3)
    restored, step = rt.restore(str(tmp_path))
    assert step == 3 and torch.is_tensor(restored["params"]["w"])
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.eye(2))


# -- end to end: the shrink ---------------------------------------------------

PARTS, PART_ROWS = 20, 2  # ten partitions an executor; global batch 4


def test_kill_shrinks_to_the_survivor_with_accumulation(tmp_path,
                                                        monkeypatch):
    from test_torch_recovery import (
        jax_replay,
        kill_engine,
        replay,
        rings_left,
        steps_log,
    )

    monkeypatch.setenv(telemetry.DIR_ENV, str(tmp_path / "telemetry"))
    tokens = np.random.default_rng(13).integers(
        0, TINY["vocab_size"], (PARTS * PART_ROWS, TINY["max_seq"])
    ).astype(np.int32)
    engine = kill_engine("feed.put:kill@7", respawns=0)
    try:
        c = TFCluster.run(
            engine, transformer_spark.main_fun,
            {"config": TINY, "batch_size": 2 * PART_ROWS, "device": "cpu",
             "seed": 0, "ckpt_dir": str(tmp_path / "ckpt"),
             "ckpt_every": 1, "ckpt_keep": 100, "elastic_data": 2,
             "out_dir": str(tmp_path)},
            num_executors=2, input_mode=TFCluster.InputMode.SPARK,
            reservation_timeout=TIMEOUT, restarts=1, min_executors=1)
        c.train(engine.parallelize(list(tokens), PARTS),
                feed_timeout=TIMEOUT)
        assert c._restarts_used == 1 and c.meta["epoch"] == 1
        assert c.meta["cluster_template"] == {"worker": [0]}
        assert c.meta["num_executors"] == 1 and len(c.cluster_info) == 1
        assert engine.alive_executors() == [0] and engine._retired == {1}
        assert c.server.fed_partitions("input") == list(range(PARTS))
        c.shutdown()
        # the dead executor's ring too: the driver unlinked it
        assert rings_left(c) == []
    finally:
        engine.stop()
    log = steps_log(str(tmp_path), 0)
    e0 = [r for r in log if r["event"] == "step" and r["epoch"] == 0]
    e1 = [r for r in log if r["event"] == "step" and r["epoch"] == 1]
    assert e0 and e1
    assert all(r["world"] == 2 and r["accum"] == 1 for r in e0)
    assert all(r["world"] == 1 and r["accum"] == 2 for r in e1)
    start1 = [r for r in log if r["event"] == "start"][1]
    resumed = start1["resumed_step"]
    assert resumed == max([r["step"] for r in e0
                           if r["save_ms"] is not None], default=0)
    assert e1[0]["step"] == resumed + 1
    want = replay(tokens, str(tmp_path / "ckpt"), resumed,
                  [e1[0]["rows"]], elastic_data=2)
    np.testing.assert_allclose(e1[0]["loss"], want[0], rtol=1e-4)
    # every resumed step against the JAX package's full-batch optax steps
    # from the checkpoint's params and Adam state
    jwant, _ = jax_replay(tokens, str(tmp_path / "ckpt"), resumed,
                          [r["rows"] for r in e1])
    np.testing.assert_allclose([r["loss"] for r in e1], jwant, rtol=1e-4)
    raw = ""
    for path in glob.glob(str(tmp_path / "telemetry" / "**" / "*.jsonl"),
                          recursive=True):
        with open(path) as f:
            raw += f.read()
    names = {json.loads(line)["name"] for line in raw.splitlines() if line}
    for ev in ("cluster/resize", "rendezvous/resize",
               "elastic/from_context", "cluster/recover_done"):
        assert ev in names, ev
