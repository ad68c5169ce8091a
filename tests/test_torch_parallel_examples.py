"""PyTorch port, the parallel layer's examples and dry run on gloo CPU
ranks:

- ``examples/transformer_longcontext`` with each ``--attn`` on 4 ranks
  (the JAX example's mesh for 4 devices: seq 2 x model 2): every rank
  reports the same losses, and they equal the one-rank run's within
  ``LOSS_RTOL`` 1e-5 relative (the sharded step computes the global
  batch's loss; only float32 summation order differs);
- ``examples/segmentation_dist`` on 2 ranks (fsdp 2) and 4 ranks
  (data 2 x fsdp 2): the printed loss of step 5 and the final BN state
  equal the single-process example's (``examples/segmentation.train``,
  the same params and batches) within ``SEG_RTOL`` 1e-4 (relative to
  the loss, and to the state tree's largest element, as
  ``tests/test_torch_segmentation.py`` holds states: after five Adam
  steps the ~0 leaves carry sign-amplified rounding noise), which global
  batch norm makes possible;
- ``parallel.dryrun.dryrun_multichip(4)`` prints its four ``OK`` lines,
  the elastic shrink's second, as the JAX dry run prints them; the
  shrink's step (2 of the 4 ranks left, the survivors on a new group,
  accumulation 2) equals the same step taken on a fresh 2-rank group
  from the same host state within ``LOSS_RTOL``, and the mean of its two
  micro-batches' losses computed in one process from that state, with
  plain PyTorch (``LOSS_RTOL``) and with the JAX package's ResNet
  (``RESNET_TRAIN_RTOL``).
"""

import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    segmentation,
    segmentation_dist,
    transformer_longcontext,
)
from tensorflowonspark_tpu_torch.parallel import dryrun  # noqa: E402

LOSS_RTOL = 1e-5
RESNET_TRAIN_RTOL = 2e-4
SEG_RTOL = 1e-4
LC = ["--device", "cpu", "--seq_len", "64", "--steps", "3", "--dim", "32"]


@pytest.fixture(scope="module")
def one_rank_losses():
    return transformer_longcontext.main(LC + ["--nprocs", "1"])[0][1]


@pytest.mark.parametrize("attn", ["ring", "zigzag", "ulysses"])
def test_transformer_longcontext_each_attn_on_four_ranks(one_rank_losses,
                                                          attn, capsys):
    results = transformer_longcontext.main(
        LC + ["--nprocs", "4", "--attn", attn])
    out = capsys.readouterr().out
    assert "mesh: {'data': 1, 'seq': 2, 'model': 2} for seq_len=64" in out
    assert "step 3: loss=" in out
    for lines, losses in results:
        np.testing.assert_allclose(losses, one_rank_losses, rtol=LOSS_RTOL)
    assert one_rank_losses[-1] < one_rank_losses[0]


SEG = ["--device", "cpu", "--steps", "5", "--image_size", "32",
       "--batch_size", "4", "--width", "0.35"]


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _items(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], np.asarray(tree.detach()))]


@pytest.mark.parametrize("nprocs", [2, 4])
def test_segmentation_dist_equals_single_process(nprocs, capsys):
    _, state = segmentation.train(argparse.Namespace(
        batch_size=4, steps=5, image_size=32, width=0.35, lr=1e-3,
        device="cpu"))
    want_loss = float(capsys.readouterr().out.split("loss=")[-1])
    results = segmentation_dist.main(SEG + ["--nprocs", str(nprocs)])
    out = capsys.readouterr().out
    axes = segmentation_dist.mesh_axes(nprocs)
    assert f"step 5: loss=" in out and f"mesh={axes}" in out
    ref = _items(state)
    scale = max(np.abs(v).max() for _, v in ref)
    for lines, losses, rank_state in results:
        assert abs(losses[-1] - want_loss) <= 1e-4 + SEG_RTOL * want_loss
        for (path, a), (_, b) in zip(_items(rank_state), ref):
            err = np.abs(a - b).max() / scale
            assert err <= SEG_RTOL, (path, err)


def test_dryrun_multichip_four_ranks(capsys):
    lines = dryrun.dryrun_multichip(4)
    out = capsys.readouterr().out.splitlines()
    assert out == lines and len(lines) == 4
    for line, what in zip(lines, ("resnet", "elastic", "transformer",
                                  "pp+ep")):
        head = (f"dryrun_multichip(4) {what}: "
                + ("4 virtual -> 2 devices accum=2 " if what == "elastic"
                   else "mesh="))
        assert line.startswith(head), line
        assert line.endswith(" OK")
        assert np.isfinite(float(line.split("loss=")[1].split()[0]))


def shrink_from_the_resnet_step(n):
    """On each of n ranks: the dry run's ResNet step, then its shrink;
    the host state the shrink started from, its batch and its loss."""
    rt, host, batch = dryrun._resnet(n, [])
    return dict(host=host, batch=batch,
                loss=dryrun._shrink(n, rt, host, batch))


def fresh_group_step(host, batch):
    """On a fresh 2-rank group: the logical mesh of 4 (data 2 x fsdp 2)
    placed straight onto these ranks (accumulation 2), the host state
    under it, one step."""
    from tensorflowonspark_tpu_torch import elastic
    from tensorflowonspark_tpu_torch.parallel import sharding

    rt = elastic.ElasticRuntime(elastic.TrainSpec({"data": 2, "fsdp": 2}),
                                devices=[torch.device("cpu")] * 2)
    assert rt.layout.accum_steps == 2
    (params, state, momentum), _ = rt.reshard_train_state(*host)
    loss, _, _ = dryrun._resnet_step(rt, params, sharding.local_tree(state),
                                     momentum, *batch)
    return loss


@pytest.fixture(scope="module")
def shrunk():
    """The dry run's ResNet step and shrink on 4 ranks: rank 0's host
    state, batch and loss, after checking which ranks stepped."""
    from tensorflowonspark_tpu_torch.parallel.launch import RankPool

    with RankPool(4) as pool:
        out = pool.run(shrink_from_the_resnet_step, 4, timeout=300)
    assert [r["loss"] is None for r in out] == [False, False, True, True]
    assert out[1]["loss"] == out[0]["loss"]
    return out[0]


def test_dryrun_shrink_step_equals_a_fresh_two_rank_step(shrunk):
    from tensorflowonspark_tpu_torch.parallel.launch import RankPool

    got = shrunk["loss"]
    with RankPool(2) as pool:
        want = pool.run(fresh_group_step, shrunk["host"], shrunk["batch"],
                        timeout=300)
    assert want[0] == want[1]
    assert abs(got - want[0]) <= LOSS_RTOL * abs(want[0]), (got, want)


def _micro_rows(n_rows, ranks=2, accum=2):
    """The rows of each micro-batch of the survivors' step: rank r holds
    rows [r*b, (r+1)*b) of the batch and takes its i-th slice of them as
    micro-batch i, whose batch norm spans that slice of every rank."""
    b = n_rows // ranks
    m = b // accum
    return [np.concatenate([np.arange(r * b + i * m, r * b + (i + 1) * m)
                            for r in range(ranks)]) for i in range(accum)]


def _plain_loss(params, state, images, labels):
    from tensorflowonspark_tpu_torch.models import layers as L
    from tensorflowonspark_tpu_torch.models import resnet

    with torch.no_grad():
        logits, _ = resnet.apply(params, state, torch.from_numpy(images),
                                 depth=18, small_inputs=True,
                                 compute_dtype=torch.float32)
        return float(L.softmax_cross_entropy(logits,
                                             torch.from_numpy(labels)))


def _jax_loss(params, state, images, labels):
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import layers as JL
    from tensorflowonspark_tpu.models import resnet as JR
    from tensorflowonspark_tpu_torch.models import resnet

    pj, sj = resnet.params_to_jax(params, state)
    logits, _ = JR.apply(pj, sj, jnp.asarray(images), depth=18, train=True,
                         small_inputs=True, compute_dtype=jnp.float32)
    return float(JL.softmax_cross_entropy(logits, jnp.asarray(labels)))


@pytest.mark.parametrize("ref,rtol", [("plain", LOSS_RTOL),
                                      ("jax", RESNET_TRAIN_RTOL)])
def test_dryrun_shrink_loss_equals_a_single_process_forward(shrunk, ref,
                                                            rtol):
    """The shrink step's loss against one process's forward, with no
    group, mesh, resharding or accumulation code: the mean of the two
    micro-batches' losses, each a training-mode forward over its rows
    from the host state; plain PyTorch, and the JAX package's ResNet
    (``RESNET_TRAIN_RTOL``, the ResNet tests' training tolerance)."""
    from torch.utils import _pytree as pytree

    params, state, _ = pytree.tree_map(torch.from_numpy, shrunk["host"])
    images, labels = shrunk["batch"]
    loss = _plain_loss if ref == "plain" else _jax_loss
    want = np.mean([loss(params, state, images[rows], labels[rows])
                    for rows in _micro_rows(len(labels))])
    got = shrunk["loss"]
    assert abs(got - want) <= rtol * abs(want), (got, want)
