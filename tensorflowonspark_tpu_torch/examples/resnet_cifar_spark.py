"""ResNet on CIFAR-shaped records, InputMode.SPARK.

Counterpart of ``examples/resnet/resnet_cifar_spark.py``: the CIFAR
plans (``--depth`` 20/32/44/56/110, width 16, the 3x3 stem), SGD(momentum
0.9), resume from the newest checkpoint under ``model_dir/ckpt`` and
chief saves in the JAX package's npz format, so either package resumes
the other's run.  On the CPU (gloo)::

    python -m tensorflowonspark_tpu_torch.examples.resnet_cifar_spark \\
        --cluster_size 2 --steps 10 --depth 20 --device cpu

On a host with GPUs, ``--num_gpus 1`` gives each executor one card.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def synthetic_records(n, seed=0):
    """``n`` (image [32, 32, 3] f32 in [0, 1), label int32) records, as
    the JAX example's ``main()`` makes them."""
    rng = np.random.default_rng(seed)
    images = rng.random((n, 32, 32, 3), dtype=np.float32)
    labels = (images.mean((1, 2, 3)) * 10).astype(np.int32) % 10
    return list(zip(list(images), list(labels)))


def collate(records):
    """(images [n, 32, 32, 3] f32, labels [n] int64) from records."""
    images = np.stack([r[0] for r in records]).astype(np.float32)
    labels = np.asarray([r[1] for r in records], dtype=np.int64)
    return images, labels


def main_fun(args, ctx):
    """Runs in every trainer.  ``args``: ``batch_size`` (global), ``lr``,
    ``depth``, ``model_dir``; optional ``save_every`` (25), ``device``
    (default the card), ``compute_dtype`` (``"bfloat16"``), ``seed`` (0,
    for the params when no checkpoint exists) and ``out_dir``, where each
    rank writes ``resnet_cifar-rank<r>.json``: the step it resumed from,
    its losses and its last step."""
    import torch

    from tensorflowonspark_tpu_torch import infeed
    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    env = ctx.torch_initialize(args.get("device"))
    dev = env["device"]
    depth = args["depth"]
    params, state = resnet.init(
        torch.Generator(device=dev).manual_seed(args.get("seed", 0)),
        depth=depth, num_classes=10, width=16, small_inputs=True, device=dev)
    leaves = [p.requires_grad_() for p in resnet.param_leaves(params)]
    opt = torch.optim.SGD(leaves, lr=args["lr"], momentum=0.9)

    # resume: params, BN state, momentum and step from the newest
    # restorable checkpoint, whichever package wrote it
    ckpt_dir = os.path.join(args["model_dir"], "ckpt")
    restored, start_step = ckpt.restore_latest(ckpt_dir)
    if restored is not None:
        resnet.restore_checkpoint_tree(restored, params, state, opt)
    step_fn = resnet.make_train_step(
        opt, depth=depth, small_inputs=True,
        compute_dtype=getattr(torch, args.get("compute_dtype", "bfloat16")))

    def save(step):
        ckpt.save_checkpoint(ckpt_dir,
                             resnet.checkpoint_tree(params, state, opt), step)

    feed = ctx.get_data_feed(train_mode=True)
    per_proc = args["batch_size"] // max(env["num_processes"], 1)
    save_every = args.get("save_every", 25)
    step, losses = start_step, []
    for images, labels in infeed.synchronized(infeed.device_feed(
            feed, per_proc, collate=collate, placement=dev), feed=feed):
        loss, acc, state = step_fn(params, state, images, labels)
        losses.append(float(loss))
        step += 1
        if step % 5 == 0 and env["process_id"] == 0:
            print(f"step {step}: loss={losses[-1]:.4f} acc={float(acc):.3f}",
                  flush=True)
        if step % save_every == 0 and ckpt.is_chief(ctx):
            save(step)
    if ckpt.is_chief(ctx):
        save(step)

    out_dir = args.get("out_dir")
    if out_dir:
        rank = env["process_id"]
        with open(os.path.join(out_dir, f"resnet_cifar-rank{rank}.json"),
                  "w") as f:
            json.dump({"rank": rank, "start_step": start_step,
                       "step": step, "losses": losses}, f)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--depth", type=int, default=20,
                   help="CIFAR plans: 20/32/44/56/110")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--model_dir", default="resnet_cifar_model")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--num_gpus", type=int, default=0)
    args = p.parse_args()

    from tensorflowonspark_tpu_torch import cluster as TFCluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    records = synthetic_records(args.batch_size * args.steps)
    engine = LocalEngine(args.cluster_size)
    try:
        cluster = TFCluster.run(
            engine, main_fun,
            {"batch_size": args.batch_size, "lr": args.lr,
             "depth": args.depth,
             "model_dir": os.path.abspath(args.model_dir),
             "device": args.device, "compute_dtype": args.compute_dtype},
            num_executors=args.cluster_size,
            input_mode=TFCluster.InputMode.SPARK, master_node="chief",
            num_gpus=args.num_gpus)
        cluster.train(engine.parallelize(records, args.cluster_size * 2),
                      num_epochs=args.epochs)
        cluster.shutdown()
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
