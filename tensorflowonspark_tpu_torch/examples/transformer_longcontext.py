"""Long-context transformer training on a data x seq x model mesh.

Counterpart of ``examples/transformer/transformer_longcontext.py``:
sequence parallelism splits the context over the ``seq`` ranks (ring,
zigzag ring or Ulysses attention, ``--attn``), Megatron tensor
parallelism splits heads and MLP over ``model``, and the rest of the
ranks split the batch.  The mesh is the JAX example's for the same
number of ranks (``--nprocs``)::

    python -m tensorflowonspark_tpu_torch.examples.transformer_longcontext \\
        --nprocs 4 --device cpu --seq_len 128 --steps 5 --attn zigzag

``--device`` defaults to the card (NCCL, one card a rank); ``cpu`` runs
gloo ranks.  On the card ``--attn ulysses`` runs the flash kernels as
its local attention.
"""

from __future__ import annotations

import argparse

import numpy as np


def mesh_axes(n, attn, n_heads):
    """The JAX example's ``data x seq x model`` split of n ranks."""
    seq = max(n // 4, 1) * 2 if n >= 8 else max(n // 2, 1)
    model = 2 if n % 2 == 0 and n >= 4 else 1
    if attn == "ulysses":
        # ulysses re-shards seq -> heads: each model shard's heads must
        # divide by seq, and seq*model must divide n
        while seq > 1 and ((n_heads // model) % seq or n % (seq * model)):
            seq //= 2
    return {"data": n // (seq * model), "seq": seq, "model": model}


def token_batches(args):
    """The JAX example's stream: next token = (2*prev + 1) % vocab."""
    rng = np.random.default_rng(0)
    for _ in range(args.steps):
        start = rng.integers(0, args.vocab, (args.batch_size, 1))
        toks = [start]
        for _ in range(args.seq_len - 1):
            toks.append((2 * toks[-1] + 1) % args.vocab)
        yield np.concatenate(toks, axis=1)


def train(args):
    """One rank's loop (in an initialised process group); returns the
    printed lines and the losses."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch import ops, resolve_device
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.parallel import (
        make_mesh,
        sequence_parallel_attention,
    )
    from tensorflowonspark_tpu_torch.parallel.mesh import mesh_shape

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    mesh = make_mesh(mesh_axes(dist.get_world_size(), args.attn,
                               args.n_heads), device_type=dev.type)
    lines = [f"mesh: {mesh_shape(mesh)} for seq_len={args.seq_len}"]
    cfg = transformer.Config(
        vocab_size=args.vocab, dim=args.dim, n_layers=args.n_layers,
        n_heads=args.n_heads, max_seq=args.seq_len, dtype="float32",
        attn_impl="reference")
    params = transformer.init(cfg, torch.Generator(device=dev).manual_seed(0))
    placed = transformer.shard_params(
        params, mesh, transformer.param_specs(cfg, mesh=mesh))
    opt = torch.optim.Adam(_leaves(placed), lr=args.lr)
    kw = {"attn_fn": ops.flash_attention} if (
        args.attn == "ulysses" and dev.type == "cuda") else {}
    attn_fn = sequence_parallel_attention(mesh, args.attn, causal=True, **kw)
    step = transformer.mesh_value_and_grad(cfg, mesh, attn_fn=attn_fn,
                                           zigzag=args.attn == "zigzag")
    losses = []
    for i, tokens in enumerate(token_batches(args), 1):
        loss = step(placed, torch.from_numpy(tokens))
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss))
        lines.append(f"step {i}: loss={losses[-1]:.4f}")
    return lines, losses


def _leaves(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_leaves(tree)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--n_layers", type=int, default=2)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--attn", choices=["ring", "zigzag", "ulysses"],
                   default="ring")
    p.add_argument("--nprocs", type=int, default=1,
                   help="ranks (processes) of the mesh")
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
