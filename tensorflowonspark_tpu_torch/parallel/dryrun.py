"""The multi-rank dry run: the JAX package's ``dryrun_multichip`` on n
gloo CPU ranks.

Counterpart of ``__graft_entry__.dryrun_multichip`` (its workloads and
their printed lines): one training step each of

1. ResNet-18 (width 16, 32x32 images) on ``data x fsdp`` through an
   ``elastic.ElasticRuntime``: params fsdp-sharded, batch norm over the
   global batch;
2. the elastic shrink: the same logical mesh on half the ranks.  Ranks
   are processes here, so half of them leave: every rank first fetches
   the train state after step 1 to the host (a sharded leaf is gathered
   over the old mesh, which needs every rank), the group is destroyed,
   and the first half form a new one.  There ``ElasticRuntime.resize``
   folds the missing ranks into gradient accumulation (2 steps),
   ``reshard_train_state`` places the state, SGD's momentum with it, on
   the new mesh, and the survivors take one more step, whose batch norm
   reduces over the new group (``utils.train.batch_group``);
3. the transformer on ``data x fsdp x seq x model``: Megatron tensor
   parallelism, zigzag ring attention when the seq axis is real (the
   contiguous ring otherwise), explicit labels and rope positions;
4. pipeline (``pp``) + expert (``ep``) parallelism: a two-stage tanh
   pipeline feeding a MoE layer whose experts are split over ``ep``.

The shrink runs last, since the leavers cannot come back, and its line
is printed second, where the JAX dry run prints it.  Run it as
``python -m tensorflowonspark_tpu_torch.parallel.dryrun 8``.
"""

from __future__ import annotations

import datetime
import sys

import numpy as np

LR = 0.1  # the ResNet steps' SGD, momentum 0.9


def _cpus(n):
    import torch

    return [torch.device("cpu")] * n


def _resnet_step(rt, params, state, momentum, images, labels):
    """One SGD step of ResNet-18 under ``rt``'s layout, at its
    accumulation depth: ``params`` placed leaves, ``state`` local,
    ``momentum`` SGD's buffers (a tree like ``params``, or None before
    the first step).  Returns the loss (mean over the group), the
    optimizer and the new state."""
    import torch
    from torch.utils import _pytree as pytree

    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.parallel import mesh as M

    opt = torch.optim.SGD(resnet.param_leaves(params), lr=LR, momentum=0.9)
    if momentum is not None:
        for p, m in zip(pytree.tree_leaves(params),
                        pytree.tree_leaves(momentum)):
            opt.state[p]["momentum_buffer"] = m
    step = resnet.make_train_step(opt, depth=18, small_inputs=True,
                                  compute_dtype=torch.float32,
                                  accum_steps=rt.layout.accum_steps)
    bsh = rt.batch_sharding()
    loss, _, state = step(params, state,
                          M.local_shard(torch.from_numpy(images), *bsh),
                          M.local_shard(torch.from_numpy(labels), *bsh))
    return _global_mean(loss), opt, state


def _resnet(n, lines):
    """Step 1; returns the runtime, the train state after the step on
    the host (params, BN state, SGD's momentum) and the batch."""
    import torch
    from torch.utils import _pytree as pytree

    from tensorflowonspark_tpu_torch import elastic
    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.parallel import mesh as M
    from tensorflowonspark_tpu_torch.parallel import sharding

    fsdp = 2 if n % 2 == 0 and n > 1 else 1
    rt = elastic.ElasticRuntime(
        elastic.TrainSpec({"data": n // fsdp, "fsdp": fsdp}),
        devices=_cpus(n))
    params, state = resnet.init(torch.Generator().manual_seed(0), depth=18,
                                num_classes=16, width=16, small_inputs=True)
    (params, state, _), _ = rt.shard_train_state(params, state, None)
    images, labels = _resnet_batch(n)
    loss, opt, state = _resnet_step(rt, params, sharding.local_tree(state),
                                    None, images, labels)
    if not np.isfinite(loss):
        raise RuntimeError(f"resnet loss {loss}")
    lines.append(f"dryrun_multichip({n}) resnet: "
                 f"mesh={M.mesh_shape(rt.mesh)} loss={loss:.4f} OK")
    momentum = pytree.tree_map(lambda p: opt.state[p]["momentum_buffer"],
                               params)
    return rt, elastic.host_fetch((params, state, momentum)), \
        (images, labels)


def _resnet_batch(n):
    batch = n * 2
    images = np.random.default_rng(0).random((batch, 32, 32, 3),
                                             dtype=np.float32)
    return images, np.arange(batch, dtype=np.int64) % 16


def _shrink_step(rt, host, batch):
    """The survivors' step: ``rt`` resized onto this process group (the
    logical mesh folded onto its ranks), the host train state ``host``
    placed under it, one step on ``batch`` at its accumulation depth.
    Returns the loss."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.parallel import sharding

    rt.resize(_cpus(dist.get_world_size()))
    (params, state, momentum), _ = rt.reshard_train_state(*host)
    loss, _, _ = _resnet_step(rt, params, sharding.local_tree(state),
                              momentum, *batch)
    return loss


def _shrink(n, rt, host, batch):
    """Half the ranks leave and the rest step on their own group;
    returns the survivors' loss, None on the leavers."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.parallel.launch import (
        PG_TIMEOUT_S,
        free_port,
    )

    half = n // 2
    rank = dist.get_rank()
    addr = [f"tcp://127.0.0.1:{free_port()}" if rank == 0 else None]
    dist.broadcast_object_list(addr, src=0)
    # every rank holds the state on its host: the leavers may go
    dist.barrier()
    dist.destroy_process_group()
    if rank >= half:
        return None
    dist.init_process_group(
        "gloo", init_method=addr[0], rank=rank, world_size=half,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        loss = _shrink_step(rt, host, batch)
    finally:
        dist.destroy_process_group()
    if not np.isfinite(loss):
        raise RuntimeError(f"elastic loss {loss}")
    return loss


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
    """One rank's dry run: the workloads; returns their lines (None on
    a rank that left at the shrink).  The process group is gone
    afterwards when ``n`` is even (the shrink destroys it)."""
    import torch

    torch.manual_seed(0)
    lines = []
    rt, host, batch = _resnet(n, lines)
    _transformer(n, lines)
    _pp_ep(n, lines)
    if n % 2 == 0 and n > 1:
        loss = _shrink(n, rt, host, batch)
        if loss is None:
            return None
        layout = rt.layout
        lines.insert(1, f"dryrun_multichip({n}) elastic: "
                        f"{layout.n_virtual} virtual -> "
                        f"{layout.n_physical} devices "
                        f"accum={layout.accum_steps} loss={loss:.4f} OK")
    return lines


def dryrun_multichip(n_devices: int) -> list:
    """One step of each workload on ``n_devices`` gloo CPU ranks, and
    the shrink to half of them when ``n_devices`` is even; prints rank
    0's lines (``resnet``, ``elastic``, ``transformer``, ``pp+ep``) and
    returns them.  Raises if a rank fails."""
    from tensorflowonspark_tpu_torch.parallel.launch import run_ranks

    lines = run_ranks(n_devices, rank_main, n_devices, backend="gloo")[0]
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
