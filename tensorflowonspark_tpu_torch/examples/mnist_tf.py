"""MNIST, InputMode.TENSORFLOW: every node reads its own data.

Counterpart of ``examples/mnist/mnist_tf.py``: the cluster gives each
node its role and the process group, and no feeder runs.  ``main_fun``
runs in the executor itself (not in a forked trainer), shards a seeded
in-memory set by the process group's rank (``process_id``, not
``ctx.task_index``: with a chief, chief:0 and worker:0 both have task
index 0), steps SGD(momentum 0.9) on random batches of its shard with
the gradients averaged over the group, and the chief exports.  On the
CPU (gloo)::

    python -m tensorflowonspark_tpu_torch.examples.mnist_tf \\
        --cluster_size 2 --device cpu

An executor that ran a ``main_fun`` on the card holds a CUDA context, so
it must not later fork a SPARK-mode trainer: run TENSORFLOW-mode jobs on
an engine of their own.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

def train(args, ctx, env, images, labels, report=None):
    """This node's part of the job, once it has its data: ``steps`` SGD
    steps on ``batch_size // num_processes`` random records of
    ``images``/``labels`` a step (``np.random.default_rng(process_id)``),
    then the chief's export to ``model_dir/export`` (with the ``predict``
    symbol in its metadata).  ``args``: ``batch_size`` (global), ``lr``,
    ``steps``, optional ``model_dir``, ``init_params`` (a JAX-layout
    params tree; default random from ``seed``) and ``out_dir``, where
    each rank writes ``mnist_tf-rank<r>.json`` (its losses, the kernels'
    launches over its steps and the entries of ``report``).  Returns the losses."""
    import torch

    from tensorflowonspark_tpu_torch import ops
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

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

    rank = env["process_id"]
    per_proc = args["batch_size"] // max(env["num_processes"], 1)
    rng = np.random.default_rng(rank)
    images_t = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    labels_t = torch.from_numpy(np.asarray(labels, np.int64))
    ops.reset_launch_counts()
    losses = []
    for step in range(1, args["steps"] + 1):
        idx = torch.from_numpy(rng.integers(0, len(images), per_proc))
        loss, acc = step_fn(params, images_t[idx].to(dev),
                            labels_t[idx].to(dev))
        losses.append(float(loss))
        if step % 10 == 0 and rank == 0:
            print(f"step {step}: loss={losses[-1]:.4f} "
                  f"acc={float(acc):.3f}", flush=True)

    if args.get("model_dir"):
        ckpt.export_model(os.path.join(args["model_dir"], "export"),
                          mnist.params_to_jax(params), ctx,
                          metadata={"predict": mnist.PREDICT})
    if args.get("out_dir"):
        with open(os.path.join(args["out_dir"], f"mnist_tf-rank{rank}.json"),
                  "w") as f:
            json.dump({"rank": rank, "pid": os.getpid(), "losses": losses,
                       "records": len(images), "device": str(dev),
                       "launches": ops.launch_counts(), **(report or {})},
                      f)
    return losses


def main_fun(args, ctx):
    """Runs in every executor: ``num_examples`` seeded records
    (``mnist_data_setup.synthetic_mnist``), this rank's every
    ``num_processes``-th, into :func:`train`.  ``device``: default the
    card."""
    from tensorflowonspark_tpu_torch.examples.mnist_data_setup import (
        synthetic_mnist,
    )

    env = ctx.torch_initialize(args.get("device"))
    images, labels = synthetic_mnist(args["num_examples"], seed=0)
    mine = np.arange(len(images)) % env["num_processes"] \
        == env["process_id"]
    train(args, ctx, env, images[mine], labels[mine])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--num_examples", type=int, default=2048)
    p.add_argument("--model_dir", default="mnist_model_tf")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    p.add_argument("--num_gpus", type=int, default=0)
    args = p.parse_args()

    from tensorflowonspark_tpu_torch import cluster as TFCluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    engine = LocalEngine(args.cluster_size)
    try:
        cluster = TFCluster.run(
            engine, main_fun,
            {"batch_size": args.batch_size, "lr": args.lr,
             "steps": args.steps, "num_examples": args.num_examples,
             "model_dir": os.path.abspath(args.model_dir),
             "device": args.device},
            num_executors=args.cluster_size,
            input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
            num_gpus=args.num_gpus)
        cluster.shutdown()
    finally:
        engine.stop()
    print("export:", os.path.join(os.path.abspath(args.model_dir), "export"))


if __name__ == "__main__":
    main()
