"""Batch norm over the global batch: the port's two-rank training steps
against the JAX package's step jitted over a two-device mesh.

The JAX package shards the batch over the mesh (``batch_sharding``), so
XLA computes batch norm's statistics over the global batch, and the
running state from them.  The port runs one process per rank (gloo, on
the CPU): each normalises with the statistics of every rank's batch
(``models.layers``, :func:`utils.train.batch_group`), and its backward
reduces the two per-channel sums across the ranks, so the averaged
gradients equal the global loss's.

The same params (the JAX model's, converted) and the same seeded numpy
batch go through both; each rank takes its half of the batch, as the
mesh does.  Held: the mean of the ranks' losses against the JAX loss
within ``LOSS_RTOL`` 1e-5 relative; every updated param (one SGD step,
lr 0.1, ``p - 0.1·g`` up to momentum's first step, which is ``g``) and
every new BN state leaf within ``RTOL`` 1e-4 of the larger of its own
largest element and ``ZERO_SCALE`` 1e-3 of its tree's largest element,
BN scale and bias leaves of the params within ``BN_PARAM_RTOL``.  The
floor is ``tests/test_torch_segmentation.py``'s (leaves whose exact
value is ~0 because a training-mode BN downstream removes them).
``BN_PARAM_RTOL`` is ``tests/test_torch_resnet.py``'s ``BN_GRAD_RTOL``:
the JAX package's float32 sums for those gradients land up to ~1e-2
off a float64 evaluation.  Every rank returns the same state (the
running statistics are global), which is also held.

With each rank's own statistics (the port before this repair) the BN
state differs from the JAX package's by O(1e-1) of its size and the
params by far more than these bounds.  One process (no group, or a
group of one) issues no collective.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from tensorflowonspark_tpu.models import resnet as JR  # noqa: E402
from tensorflowonspark_tpu.models import segmentation as JS  # noqa: E402
from tensorflowonspark_tpu_torch.models import resnet as R  # noqa: E402
from tensorflowonspark_tpu_torch.models import segmentation as S  # noqa: E402
from tensorflowonspark_tpu_torch.parallel.launch import RankPool  # noqa: E402

LOSS_RTOL = 1e-5
RTOL = 1e-4
BN_PARAM_RTOL = 2e-2
ZERO_SCALE = 1e-3
LR = 0.1
TIMEOUT = 240


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _items(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], np.asarray(tree))]


def _close_trees(got, ref, what, rtol=RTOL, bn_rtol=None):
    g, r = _items(got), _items(ref)
    assert [p for p, _ in g] == [p for p, _ in r], what
    floor = ZERO_SCALE * max(np.abs(b).max() for _, b in r)
    worst = 0.0
    for (path, a), (_, b) in zip(g, r):
        assert a.shape == b.shape, (what, path, a.shape, b.shape)
        leaf = path.rsplit("/", 1)[-1]
        tol = bn_rtol if bn_rtol and leaf in ("scale", "bias") else rtol
        scale = max(np.abs(b).max(), floor)
        err = np.abs(a.astype(np.float64) - b).max() / scale
        assert err <= tol, (what, path, err)
        worst = max(worst, err / tol)
    return worst


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2, env={"OMP_NUM_THREADS": "2"})
    yield p
    p.close()


def _mesh2():
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _jax_step(step, pj, sj, opt, images, labels):
    mesh = _mesh2()
    rep, bsh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    ostate = opt.init(pj)
    put = jax.device_put
    out = jax.jit(step)(put(pj, rep), put(sj, rep), put(ostate, rep),
                        put(jnp.asarray(images), bsh),
                        put(jnp.asarray(labels), bsh))
    return _np_tree(out)


# -- ResNet-18, width 16, 32x32, batch 8 -------------------------------------

R18 = dict(depth=18, small_inputs=True)


def _resnet_data():
    pj, sj = jax.jit(lambda k: JR.init(k, num_classes=10, width=16,
                                       **R18))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    images = rng.random((8, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    return _np_tree(pj), _np_tree(sj), images, labels


def _rank_half(x):
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    r = dist.get_rank() if dist.is_initialized() else 0
    b = len(x) // n
    return torch.from_numpy(np.ascontiguousarray(x[r * b:(r + 1) * b]))


def rank_resnet_step(pj, sj, images, labels):
    """One port step on this rank's half of the batch."""
    pt, st = R.params_from_jax(pj, sj, device="cpu")
    leaves = [p.requires_grad_() for p in R.param_leaves(pt)]
    step = R.make_train_step(torch.optim.SGD(leaves, lr=LR, momentum=0.9),
                             compute_dtype=torch.float32, **R18)
    loss, _, st = step(pt, st, _rank_half(images),
                       _rank_half(labels.astype(np.int64)))
    params, state = R.params_to_jax(pt, st)
    return float(loss), params, state


def test_resnet18_two_rank_step_matches_jax_mesh(pool):
    pj, sj, images, labels = _resnet_data()
    opt = optax.sgd(LR, momentum=0.9)
    jp, js, _, jloss, _ = _jax_step(
        JR.make_train_step(opt, compute_dtype=jnp.float32, **R18),
        pj, sj, opt, images, labels)
    ranks = pool.run(rank_resnet_step, pj, sj, images, labels,
                     timeout=TIMEOUT)
    loss = np.mean([r[0] for r in ranks])
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for i, (_, params, state) in enumerate(ranks):
        print("resnet18 rank", i, "loss err",
              abs(loss - float(jloss)) / abs(float(jloss)),
              "params share",
              _close_trees(params, jp, f"rank {i} params",
                           bn_rtol=BN_PARAM_RTOL),
              "state share", _close_trees(state, js, f"rank {i} state"))
    for a, b in zip(_items(ranks[0][2]), _items(ranks[1][2])):
        np.testing.assert_array_equal(a[1], b[1], err_msg=a[0])


# -- MobileNetV2-UNet, width 0.35, 32x32, batch 4 ----------------------------

SEG = dict(width=0.35, hw=32, batch=4)


def _seg_data():
    pj, sj = jax.jit(lambda k: JS.init(k, num_classes=3,
                                       width=SEG["width"]))(
        jax.random.PRNGKey(1))
    rng = np.random.default_rng(4)
    images = rng.random((SEG["batch"], SEG["hw"], SEG["hw"], 3),
                        dtype=np.float32)
    masks = rng.integers(0, 3, (SEG["batch"], SEG["hw"], SEG["hw"])
                         ).astype(np.int32)
    return _np_tree(pj), _np_tree(sj), images, masks


def rank_segmentation_step(pj, sj, images, masks):
    pt, st = S.params_from_jax(pj, sj, device="cpu")
    leaves = [p.requires_grad_() for p in S.param_leaves(pt)]
    step = S.make_train_step(torch.optim.SGD(leaves, lr=LR))
    loss, st = step(pt, st, _rank_half(images),
                    _rank_half(masks.astype(np.int64)))
    params, state = S.params_to_jax(pt, st)
    return float(loss), params, state


def test_segmentation_two_rank_step_matches_jax_mesh(pool):
    pj, sj, images, masks = _seg_data()
    opt = optax.sgd(LR)
    jp, js, _, jloss = _jax_step(JS.make_train_step(opt), pj, sj, opt,
                                 images, masks)
    ranks = pool.run(rank_segmentation_step, pj, sj, images, masks,
                     timeout=TIMEOUT)
    loss = np.mean([r[0] for r in ranks])
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for i, (_, params, state) in enumerate(ranks):
        print("segmentation rank", i, "loss err",
              abs(loss - float(jloss)) / abs(float(jloss)),
              "params share", _close_trees(params, jp, f"rank {i} params"),
              "state share", _close_trees(state, js, f"rank {i} state"))
    for a, b in zip(_items(ranks[0][2]), _items(ranks[1][2])):
        np.testing.assert_array_equal(a[1], b[1], err_msg=a[0])


# -- one process: no collective ----------------------------------------------

def _count_collectives(monkeypatch):
    import torch.distributed as dist

    calls = []
    for name in ("all_reduce", "all_gather", "broadcast"):
        real = getattr(dist, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(dist, name, spy)
    return calls


@pytest.mark.parametrize("group", ["none", "world1"])
def test_one_process_issues_no_collective(monkeypatch, tmp_path, group):
    """Without a process group, and in a group of one process, the BN
    step is the one-process step and calls no collective."""
    import torch.distributed as dist

    pj, sj, images, labels = _resnet_data()
    ref = rank_resnet_step(pj, sj, images[:4], labels[:4])
    if group == "world1":
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
            rank=0, world_size=1)
    try:
        calls = _count_collectives(monkeypatch)
        got = rank_resnet_step(pj, sj, images[:4], labels[:4])
    finally:
        if group == "world1":
            dist.destroy_process_group()
    assert calls == []
    assert got[0] == ref[0]
    for a, b in zip(_items(got[1]), _items(ref[1])):
        np.testing.assert_array_equal(a[1], b[1], err_msg=a[0])
