"""MNIST over a stream of micro-batches, InputMode.SPARK.

Counterpart of ``examples/mnist/mnist_spark_streaming.py``: the driver
feeds a stream of datasets through ``TFCluster.train_stream``, one
micro-batch after the other, and every trainer steps SGD(momentum 0.9)
for as long as the feed lasts; the chief exports.  Stop the stream early
from another shell with the command the driver prints
(``examples/stop_streaming.py``: STOP to the rendezvous server, and the
stream ends after the micro-batch in flight).  On the CPU (gloo)::

    python -m tensorflowonspark_tpu_torch.examples.mnist_spark_streaming \\
        --cluster_size 2 --micro_batches 20 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def pad_tail(images, labels, n):
    """A batch shorter than ``n`` (the stream's last) repeated up to
    ``n`` rows, as the JAX example pads it."""
    if len(labels) >= n:
        return images, labels
    reps = -(-n // len(labels))
    return (np.tile(images, (reps, 1, 1, 1))[:n],
            np.tile(labels, reps)[:n])


def main_fun(args, ctx):
    """Runs in every trainer.  ``args``: ``batch_size`` (global), ``lr``,
    optional ``device`` (default the card), ``init_params`` (a JAX-layout
    params tree; default random from ``seed``), ``model_dir`` (the
    chief's export goes to ``<model_dir>/export``) and ``out_dir``
    (each rank writes its losses to ``stream-rank<r>.json``)."""
    import torch

    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

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
    step_fn = mnist.make_train_step(
        torch.optim.SGD(leaves, lr=args["lr"], momentum=0.9))

    feed = ctx.get_data_feed(train_mode=True)
    per_proc = max(args["batch_size"] // max(env["num_processes"], 1), 1)
    losses = []
    while not feed.should_stop():
        batch = feed.next_batch(per_proc)
        if not batch:
            continue
        images, labels = pad_tail(
            np.stack([b[0] for b in batch]).astype(np.float32),
            np.asarray([b[1] for b in batch], dtype=np.int64), per_proc)
        loss, _ = step_fn(params, torch.from_numpy(images).to(dev),
                          torch.from_numpy(labels).to(dev))
        losses.append(float(loss))
        if len(losses) % 10 == 0 and ctx.task_index == 0:
            print(f"stream step {len(losses)}: loss={losses[-1]:.4f}",
                  flush=True)

    if args.get("model_dir") and ckpt.is_chief(ctx):
        ckpt.export_model(os.path.join(args["model_dir"], "export"),
                          mnist.params_to_jax(params), ctx,
                          metadata={"predict": mnist.PREDICT})
    if args.get("out_dir"):
        rank = env["process_id"]
        with open(os.path.join(args["out_dir"], f"stream-rank{rank}.json"),
                  "w") as f:
            json.dump({"rank": rank, "losses": losses,
                       "records": feed.records}, f)


def micro_batch_stream(engine, args):
    """The stream: ``args.micro_batches`` datasets of ``2 *
    args.batch_size`` synthetic records (micro-batch i from seed i), in
    ``args.cluster_size`` partitions, ``args.interval`` seconds apart.
    A Spark deployment passes a DStream to ``TFCluster.train``
    instead."""
    from tensorflowonspark_tpu_torch.examples.mnist_data_setup import (
        synthetic_mnist,
    )

    for i in range(args.micro_batches):
        images, labels = synthetic_mnist(args.batch_size * 2, seed=i)
        yield engine.parallelize(list(zip(list(images), list(labels))),
                                 args.cluster_size)
        time.sleep(args.interval)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--micro_batches", type=int, default=20)
    p.add_argument("--interval", type=float, default=0.0,
                   help="seconds between micro-batches")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    p.add_argument("--num_gpus", type=int, default=0)
    p.add_argument("--model_dir", default="mnist_model_streaming")
    args = p.parse_args()

    from tensorflowonspark_tpu_torch import cluster as TFCluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    model_dir = os.path.abspath(args.model_dir)
    engine = LocalEngine(args.cluster_size)
    try:
        cluster = TFCluster.run(
            engine, main_fun,
            {"batch_size": args.batch_size, "lr": args.lr,
             "device": args.device, "model_dir": model_dir},
            num_executors=args.cluster_size,
            input_mode=TFCluster.InputMode.SPARK, master_node="chief",
            num_gpus=args.num_gpus)
        host, port = cluster.cluster_meta["server_addr"]
        print(f"rendezvous server at {host}:{port}; stop early with:\n"
              f"  python -m tensorflowonspark_tpu_torch.examples."
              f"stop_streaming {host} {port}", flush=True)
        cluster.train_stream(micro_batch_stream(engine, args))
        cluster.shutdown(grace_secs=5)
    finally:
        engine.stop()
    print("export:", os.path.join(model_dir, "export"))


if __name__ == "__main__":
    main()
