"""MNIST, InputMode.TENSORFLOW over TFRecords: each rank reads its own
part files.

Counterpart of ``examples/mnist/mnist_tf_ds.py``: ``main_fun`` runs in
the executor, resolves ``data_dir`` with ``ctx.absolute_path``, takes
every ``num_processes``-th part file from its rank on (the process
group's rank, ``process_id``), bulk-loads them
(``dfutil.load_tfrecords_columnar``) and trains as ``mnist_tf`` does;
the chief exports.  The JAX example shards by ``ctx.task_index`` over
``ctx.num_workers``, so with a chief, chief:0 and worker:0 read the same
files and half of them go unread; the port shards by rank, as the JAX
``mnist_tf.py`` warns one must.  On the CPU::

    python -m tensorflowonspark_tpu_torch.examples.mnist_data_setup \\
        --output mnist_data
    python -m tensorflowonspark_tpu_torch.examples.mnist_tf_ds \\
        --data_dir mnist_data/tfr --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main_fun(args, ctx):
    """Runs in every executor.  ``args``: ``data_dir`` (TFRecord part
    files of ``{"image": 784 floats, "label": int}``), and what
    ``mnist_tf.train`` takes; ``device``: default the card.  A rank
    whose files hold no record raises."""
    from tensorflowonspark_tpu_torch import dfutil
    from tensorflowonspark_tpu_torch.examples import mnist_tf

    env = ctx.torch_initialize(args.get("device"))
    rank, nproc = env["process_id"], env["num_processes"]
    files = dfutil.part_files(
        ctx.absolute_path(args["data_dir"]))[rank::nproc]
    cols = dfutil.load_tfrecords_columnar(files)
    if not cols:
        raise RuntimeError(
            f"rank {rank}/{nproc} got no data: shard subset "
            f"{files or '(empty)'}; fewer non-empty part files than "
            "ranks?")
    images = np.asarray(cols["image"], np.float32).reshape(-1, 28, 28, 1)
    labels = np.asarray(cols["label"], np.int64)
    if labels.ndim != 1:
        raise ValueError(f"expected scalar labels, got {labels.shape}")
    print(f"rank {rank}: {len(images)} examples from {len(files)} shards",
          flush=True)
    mnist_tf.train(args, ctx, env, images, labels,
                   report={"files": [os.path.basename(f) for f in files]})


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--data_dir", default="mnist_data/tfr")
    p.add_argument("--model_dir", default="mnist_model_tf_ds")
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
             "steps": args.steps, "data_dir": args.data_dir,
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
