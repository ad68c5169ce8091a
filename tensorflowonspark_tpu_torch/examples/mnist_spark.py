"""MNIST, InputMode.SPARK: engine partitions stream into data-parallel
training.

Counterpart of ``examples/mnist/mnist_spark.py``: the driver starts a
cluster on a ``LocalEngine``, feeds partitioned (image, label) records
through each executor's ``DataFeed``, and every trainer steps
SGD(momentum 0.9) on its share, with the gradients all-reduced over the
process group.  On the CPU (gloo)::

    python -m tensorflowonspark_tpu_torch.examples.mnist_spark \\
        --cluster_size 2 --device cpu

On a host with GPUs, ``--device cuda --num_gpus 1`` gives each executor
one card (NCCL).  The chief saves the trained params as the checkpoint
of its last step under ``--model_dir``/ckpt and exports them to
``--model_dir``/export (``utils.checkpoint``, in the JAX package's
layout, so either package restores and loads them); ``--out_dir`` gets
each rank's losses and final params.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def synthetic_records(n, seed=0):
    """``n`` learnable (image [28, 28, 1] f32, label int32) records: the
    label depends on the quadrants' mean brightness, as in the JAX
    package's ``mnist.synthetic_batch`` (numpy here)."""
    rng = np.random.default_rng(seed)
    images = rng.random((n, 28, 28, 1), dtype=np.float32)
    q = np.stack([images[:, :14, :14, 0].mean((1, 2)),
                  images[:, :14, 14:, 0].mean((1, 2)),
                  images[:, 14:, :14, 0].mean((1, 2)),
                  images[:, 14:, 14:, 0].mean((1, 2))], axis=-1)
    labels = (np.argmax(q, axis=-1) * 2 + (q.sum(-1) > 2.0)).astype(np.int32)
    return list(zip(list(images), list(labels)))


def collate(records):
    """(images [n, 28, 28, 1] f32, labels [n] int64) from records."""
    images = np.stack([r[0] for r in records]).astype(np.float32)
    labels = np.asarray([r[1] for r in records], dtype=np.int64)
    return images, labels


def main_fun(args, ctx):
    """Runs in every trainer.  ``args``: ``batch_size`` (global), ``lr``,
    optional ``device`` (default the card), ``init_params`` (a JAX-layout
    params tree; default random from ``seed``), ``model_dir`` (where the
    chief checkpoints and exports) and ``out_dir`` (where each rank writes
    ``mnist-rank<r>.json``, with what its ``DataFeed`` saw,
    ``DataFeed.stats``, and ``.npz``)."""
    import torch

    from tensorflowonspark_tpu_torch import infeed
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt
    from tensorflowonspark_tpu_torch.utils.metrics import TrainMetrics

    env = ctx.torch_initialize(args.get("device"))
    dev = env["device"]
    if args.get("init_params") is not None:
        params = mnist.params_from_jax(args["init_params"], device=dev)
    else:
        params = mnist.init_params(
            torch.Generator(device=dev).manual_seed(args.get("seed", 0)),
            device=dev)
    leaves = [p.requires_grad_() for layer in params.values()
              for p in layer.values()]
    opt = torch.optim.SGD(leaves, lr=args["lr"], momentum=0.9)
    step_fn = mnist.make_train_step(opt)

    tm = TrainMetrics(window=10)
    feed = ctx.get_data_feed(train_mode=True, metrics=tm)
    per_proc = args["batch_size"] // max(env["num_processes"], 1)
    losses = []
    # synchronized: every process stops on the same step at the end of
    # the feed, whatever its ragged tail
    for images, labels in infeed.synchronized(infeed.device_feed(
            feed, per_proc, collate=collate, placement=dev), feed=feed):
        loss, acc = step_fn(params, images, labels)
        losses.append(float(loss))
        tm.step(items=per_proc)
        if len(losses) % 10 == 0 and env["process_id"] == 0:
            print(f"step {len(losses)}: loss={losses[-1]:.4f} "
                  f"acc={float(acc):.3f}", flush=True)

    if args.get("model_dir") and ckpt.is_chief(ctx):
        tree = mnist.params_to_jax(params)
        ckpt.save_checkpoint(os.path.join(args["model_dir"], "ckpt"), tree,
                             len(losses))
        ckpt.export_model(os.path.join(args["model_dir"], "export"), tree,
                          ctx, metadata={"predict": mnist.PREDICT})
    out_dir = args.get("out_dir")
    if out_dir:
        rank = env["process_id"]
        with open(os.path.join(out_dir, f"mnist-rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "losses": losses, "pid": os.getpid(),
                       "report": tm.report(), "feed": feed.stats()}, f)
        np.savez(os.path.join(out_dir, f"mnist-rank{rank}.npz"),
                 **{f"{n}.{k}": v.detach().cpu().numpy()
                    for n, layer in params.items() for k, v in layer.items()})


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--steps", type=int, default=40,
                   help="global batches of data to feed")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    p.add_argument("--num_gpus", type=int, default=0)
    p.add_argument("--model_dir", default="mnist_model")
    p.add_argument("--out_dir", default=None)
    args = p.parse_args()

    from tensorflowonspark_tpu_torch import cluster as TFCluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    records = synthetic_records(args.batch_size * args.steps)
    engine = LocalEngine(args.cluster_size)
    try:
        cluster = TFCluster.run(
            engine, main_fun,
            {"batch_size": args.batch_size, "lr": args.lr,
             "device": args.device, "out_dir": args.out_dir,
             "model_dir": os.path.abspath(args.model_dir)},
            num_executors=args.cluster_size,
            input_mode=TFCluster.InputMode.SPARK, master_node="chief",
            num_gpus=args.num_gpus)
        cluster.train(engine.parallelize(records, args.cluster_size * 2))
        cluster.shutdown()
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
