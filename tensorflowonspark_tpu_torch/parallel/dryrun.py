"""The multi-rank dry run: the JAX package's ``dryrun_multichip`` on n
gloo CPU ranks.

Counterpart of ``__graft_entry__.dryrun_multichip`` (its three
workloads and their printed lines): one training step each of

1. ResNet-18 (width 16, 32x32 images) on ``data x fsdp``: params
   fsdp-sharded (``shard_train_state``), batch norm over the global
   batch;
2. the transformer on ``data x fsdp x seq x model``: Megatron tensor
   parallelism, zigzag ring attention when the seq axis is real (the
   contiguous ring otherwise), explicit labels and rope positions;
3. pipeline (``pp``) + expert (``ep``) parallelism: a two-stage tanh
   pipeline feeding a MoE layer whose experts are split over ``ep``.

The JAX dry run also shrinks the ResNet mesh onto half the devices
(its elastic runtime); here that would take half the ranks out of the
group, which this dry run does not do (ROADMAP.md queue 1, item 13's
residue; the port's runtime is ``elastic``).
Run it as ``python -m tensorflowonspark_tpu_torch.parallel.dryrun 8``.
"""

from __future__ import annotations

import sys

import numpy as np


def _resnet(n, lines):
    import torch

    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.parallel import (
        batch_sharding,
        make_mesh,
        shard_train_state,
    )
    from tensorflowonspark_tpu_torch.parallel import mesh as M
    from tensorflowonspark_tpu_torch.parallel import sharding

    fsdp = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh({"data": n // fsdp, "fsdp": fsdp}, device_type="cpu")
    params, state = resnet.init(torch.Generator().manual_seed(0), depth=18,
                                num_classes=16, width=16, small_inputs=True)
    (params, state, _), _ = shard_train_state(mesh, params, state)
    state = sharding.local_tree(state)
    step = resnet.make_train_step(
        torch.optim.SGD(resnet.param_leaves(params), lr=0.1, momentum=0.9),
        depth=18, small_inputs=True, compute_dtype=torch.float32)
    batch = n * 2
    images = torch.from_numpy(np.random.default_rng(0).random(
        (batch, 32, 32, 3), dtype=np.float32))
    labels = torch.arange(batch) % 16
    bsh = batch_sharding(mesh)
    loss, _, _ = step(params, state, M.local_shard(images, *bsh),
                      M.local_shard(labels, *bsh))
    loss = _global_mean(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"resnet loss {loss}")
    lines.append(f"dryrun_multichip({n}) resnet: mesh={M.mesh_shape(mesh)} "
                 f"loss={loss:.4f} OK")


def _transformer(n, lines):
    import torch

    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.parallel import (
        make_mesh,
        sequence_parallel_attention,
    )

    axes = {"data": 1, "fsdp": 1, "seq": 1, "model": 1}
    rest = n
    for name in ("model", "seq", "data"):  # greedy 2s: 8 -> 2x2x2
        if rest % 2 == 0:
            axes[name], rest = 2, rest // 2
    axes["data"] *= rest  # any odd remainder rides the data axis
    mesh = make_mesh(axes, device_type="cpu")
    cfg = transformer.Config(
        vocab_size=64 * axes["model"], dim=16 * axes["model"], n_layers=2,
        n_heads=2 * axes["model"], max_seq=64, dtype="float32",
        attn_impl="reference")
    params = transformer.init(cfg, torch.Generator().manual_seed(1))
    placed = transformer.shard_params(
        params, mesh, transformer.param_specs(cfg, mesh=mesh))
    opt = torch.optim.Adam(_leaves(placed), lr=1e-3)
    zigzag = axes["seq"] > 1
    attn_fn = sequence_parallel_attention(
        mesh, "zigzag" if zigzag else "ring", causal=True)
    seq_len = 4 * axes["seq"] * 8
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2 * axes["data"] * axes["fsdp"], seq_len)))
    step = transformer.mesh_value_and_grad(cfg, mesh, attn_fn=attn_fn,
                                           zigzag=zigzag)
    loss = float(step(placed, tokens))
    opt.step()
    if not np.isfinite(loss):
        raise RuntimeError(f"transformer loss {loss}")
    lines.append(f"dryrun_multichip({n}) transformer: mesh={axes} "
                 f"loss={loss:.4f} OK")


def _pp_ep(n, lines):
    import torch

    from tensorflowonspark_tpu_torch.models import moe
    from tensorflowonspark_tpu_torch.parallel import (
        apply_shardings,
        make_mesh,
        pipeline_apply,
        sharded,
        stack_stage_params,
        stage_sharding,
    )
    from tensorflowonspark_tpu_torch.parallel.mesh import mesh_shape

    pp = 2 if n % 2 == 0 else 1
    ep = n // pp
    mesh = make_mesh({"pp": pp, "ep": ep}, device_type="cpu")
    dim = 16
    gen = torch.Generator().manual_seed(2)
    stages = [{"w": torch.randn((dim, dim), generator=gen) / np.sqrt(dim)}
              for _ in range(pp)]
    stacked = stack_stage_params(stages)
    placed_stages = apply_shardings(
        {k: v.requires_grad_() for k, v in stacked.items()},
        stage_sharding(mesh, stacked))
    mparams = moe.init(torch.Generator().manual_seed(3), dim=dim, hidden=32,
                       num_experts=max(2 * ep, 2))
    specs = moe.param_specs(ep_axis="ep")
    mplaced = apply_shardings(
        {k: v.requires_grad_() for k, v in mparams.items()},
        {k: sharded(mesh, *spec) for k, spec in specs.items()})
    x = torch.from_numpy(np.random.default_rng(2).random(
        (8, dim), dtype=np.float32))
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), placed_stages,
                       x, mesh=mesh, n_microbatches=4)
    z, aux = moe.apply(_local_grad(mplaced), y[:, None, :],
                       ep_group=mesh.get_group("ep"))
    loss = (z ** 2).sum() + aux
    loss.backward()
    loss = float(loss.detach())
    if not np.isfinite(loss):
        raise RuntimeError(f"pp+ep loss {loss}")
    lines.append(f"dryrun_multichip({n}) pp+ep: mesh={mesh_shape(mesh)} "
                 f"loss={loss:.4f} OK")


def _local_grad(tree):
    """DTensor leaves -> this rank's blocks, differentiably."""
    return {k: v.to_local() for k, v in tree.items()}


def _leaves(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_leaves(tree)


def _global_mean(x):
    import torch.distributed as dist

    x = x.clone()
    dist.all_reduce(x)
    return float(x) / dist.get_world_size()


def rank_main(n):
    """One rank's dry run: the three workloads; returns their lines."""
    import torch

    torch.manual_seed(0)
    lines = []
    _resnet(n, lines)
    _transformer(n, lines)
    _pp_ep(n, lines)
    return lines


def dryrun_multichip(n_devices: int) -> list:
    """One step of each workload on ``n_devices`` gloo CPU ranks; prints
    rank 0's three lines and returns them.  Raises if a rank fails."""
    from tensorflowonspark_tpu_torch.parallel.launch import run_ranks

    lines = run_ranks(n_devices, rank_main, n_devices, backend="gloo")[0]
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
