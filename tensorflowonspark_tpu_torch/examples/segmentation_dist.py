"""U-Net segmentation over a process group: step 2 of the conversion
ladder.

Counterpart of ``examples/segmentation/segmentation_dist.py``: the same
delta from ``segmentation.py`` (a mesh and a sharded batch), over a
``data x fsdp`` mesh of ``--nprocs`` ranks.  Every rank draws the same
global batch (numpy seed 0) and trains on its block of it.  The params
are fsdp-sharded (``shard_train_state``); ``make_train_step`` gathers
them for the step and reduce-scatters their gradients, and batch norm
normalises with the global batch's statistics, as the JAX example's
mesh-sharded batch does::

    python -m tensorflowonspark_tpu_torch.examples.segmentation_dist \\
        --nprocs 4 --device cpu --steps 10

``--device`` defaults to the card (NCCL, one card a rank); ``cpu`` runs
gloo ranks.
"""

from __future__ import annotations

import argparse

import numpy as np

from tensorflowonspark_tpu_torch.examples.segmentation import synthetic_pets


def mesh_axes(n):
    """``data x fsdp`` for n ranks: fsdp 2 when n is even."""
    fsdp = 2 if n % 2 == 0 and n > 1 else 1
    return {"data": n // fsdp, "fsdp": fsdp}


def train(args):
    """One rank's loop (in an initialised process group); returns the
    printed lines, the global batch's losses and the state."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch import resolve_device
    from tensorflowonspark_tpu_torch.models import segmentation
    from tensorflowonspark_tpu_torch.parallel import (
        batch_sharding,
        make_mesh,
        shard_train_state,
    )
    from tensorflowonspark_tpu_torch.parallel import mesh as M
    from tensorflowonspark_tpu_torch.parallel import sharding

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    mesh = make_mesh(mesh_axes(dist.get_world_size()), device_type=dev.type)
    bsh = batch_sharding(mesh)

    images, masks = synthetic_pets(args.batch_size * 4, hw=args.image_size)
    params, state = segmentation.init(
        torch.Generator(device=dev).manual_seed(0), num_classes=3,
        width=args.width, device=dev)
    (params, state, _), _ = shard_train_state(mesh, params, state)
    state = sharding.local_tree(state)
    step_fn = segmentation.make_train_step(
        torch.optim.Adam(segmentation.param_leaves(params), lr=args.lr))

    rng = np.random.default_rng(0)
    lines, losses = [], []
    for step in range(1, args.steps + 1):
        idx = rng.integers(0, len(images), args.batch_size)
        x = M.local_shard(torch.from_numpy(images[idx]), *bsh).to(dev)
        m = M.local_shard(torch.from_numpy(masks[idx]), *bsh).to(dev)
        loss, state = step_fn(params, state, x, m)
        # the global batch's loss: the ranks' local means, averaged
        g = loss.clone()
        dist.all_reduce(g)
        losses.append(float(g) / dist.get_world_size())
        if step % 5 == 0:
            lines.append(f"step {step}: loss={losses[-1]:.4f} "
                         f"(mesh={M.mesh_shape(mesh)})")
    return lines, losses, sharding.local_tree(state)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--width", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--nprocs", type=int, default=1,
                   help="ranks (processes) of the data x fsdp mesh")
    p.add_argument("--device", default=None,
                   help="'cpu' for gloo ranks on the CPU; default the card")
    args = p.parse_args(argv)
    from tensorflowonspark_tpu_torch.parallel.launch import run_ranks

    backend = "gloo" if args.device == "cpu" else "nccl"
    results = run_ranks(args.nprocs, train, args, backend=backend)
    for line in results[0][0]:
        print(line)
    return results


if __name__ == "__main__":
    main()
