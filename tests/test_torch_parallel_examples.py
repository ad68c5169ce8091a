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
- ``parallel.dryrun.dryrun_multichip(4)`` prints its three ``OK`` lines.
"""

import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    segmentation,
    segmentation_dist,
    transformer_longcontext,
)
from tensorflowonspark_tpu_torch.parallel import dryrun  # noqa: E402

LOSS_RTOL = 1e-5
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
    assert out == lines and len(lines) == 3
    for line, what in zip(lines, ("resnet", "transformer", "pp+ep")):
        assert line.startswith(f"dryrun_multichip(4) {what}: mesh=")
        assert line.endswith(" OK")
        assert np.isfinite(float(line.split("loss=")[1].split()[0]))
