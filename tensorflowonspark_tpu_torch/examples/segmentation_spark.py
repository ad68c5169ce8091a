"""U-Net segmentation, cluster-fed: step 3 of the conversion ladder.

Counterpart of ``examples/segmentation/segmentation_spark.py``: the
training loop of the single-process example with its input swapped for
the cluster's ``DataFeed``.  Each record is one ``synthetic_pets``
(image [S, S, 3] f32, mask [S, S] int32) pair; the trainer reads
``next_batch(per_proc)`` batches and skips short ones
(``infeed.batch_iterator``), stages them on the device
(``infeed.device_feed``) and steps Adam(``lr``) in float32; the chief
saves the params in the JAX package's npz layout.  On the CPU (gloo)::

    python -m tensorflowonspark_tpu_torch.examples.segmentation_spark \\
        --cluster_size 2 --steps 6 --device cpu

On a host with GPUs, ``--num_gpus 1`` gives each executor one card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def collate(records):
    """(images [n, S, S, 3] f32, masks [n, S, S] int32) from records."""
    images = np.stack([r[0] for r in records]).astype(np.float32)
    masks = np.stack([r[1] for r in records]).astype(np.int32)
    return images, masks


def main_fun(args, ctx):
    """Runs in every trainer.  ``args``: ``batch_size`` (global), ``lr``,
    ``width``, ``model_dir``; optional ``device`` (default the card),
    ``init_params`` (a JAX-layout params tree, 3 classes; default random
    from ``seed``, 0; the BN state starts at its init either way) and
    ``out_dir``, where each rank writes ``segmentation-rank<r>.json``:
    its losses, step times (CUDA events on a card), the records its
    ``DataFeed`` handed out and what the feed saw (``DataFeed.stats``:
    transport, columnar chunks, pop times; the feeders' timings from the
    node's KV; the copies into pinned memory), the kernels' launches over
    its steps, ``TrainMetrics`` report, feed wait and peak device
    memory.  Every process normalises with its own batch statistics and
    averages the gradients (``segmentation.make_train_step``)."""
    main_start_wall = time.time()
    import torch

    from tensorflowonspark_tpu_torch import infeed, ops
    from tensorflowonspark_tpu_torch.models import segmentation
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt
    from tensorflowonspark_tpu_torch.utils import metrics

    env = ctx.torch_initialize(args.get("device"))
    dev = env["device"]
    cuda = dev.type == "cuda"
    if cuda:
        # float32 stays float32, as the JAX lane computes it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params, state = segmentation.init(
        torch.Generator(device=dev).manual_seed(args.get("seed", 0)),
        num_classes=3, width=args["width"])
    if args.get("init_params") is not None:
        params, _ = segmentation.params_from_jax(args["init_params"],
                                                 device=dev)
    leaves = [p.requires_grad_() for p in segmentation.param_leaves(params)]
    step_fn = segmentation.make_train_step(
        torch.optim.Adam(leaves, lr=args["lr"]))

    per_proc = args["batch_size"] // max(env["num_processes"], 1)
    # no MFU here: TrainMetrics' peak is the card's bf16 one, and this
    # step computes in float32
    tm = metrics.TrainMetrics()
    feed = ctx.get_data_feed(train_mode=True)
    batches = iter(infeed.synchronized(infeed.device_feed(
        feed, per_proc, collate=collate, placement=dev), feed=feed))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    losses, step_ms = [], []
    while True:
        # the host's wait for the next staged batch: infeed_stall_frac
        t_wait = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            break
        if losses:
            tm.infeed_wait(time.perf_counter() - t_wait)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        loss, state = step_fn(params, state, *batch)
        if cuda:
            end.record()
        losses.append(loss.item())  # waits for the step
        if cuda:
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        else:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        tm.step(items=per_proc * env["num_processes"], loss=losses[-1])
        if len(losses) % 5 == 0 and env["process_id"] == 0:
            print(f"step {len(losses)}: loss={losses[-1]:.4f}", flush=True)

    if ckpt.is_chief(ctx):
        ckpt.save_checkpoint(os.path.join(args["model_dir"], "ckpt"),
                             segmentation.params_to_jax(params)[0],
                             len(losses))
    out_dir = args.get("out_dir")
    if out_dir:
        rank = env["process_id"]
        with open(os.path.join(out_dir, f"segmentation-rank{rank}.json"),
                  "w") as f:
            json.dump({
                "rank": rank, "pid": os.getpid(), "device": str(dev),
                "losses": losses, "step_ms": step_ms,
                "records": feed.records, "train_metrics": tm.report(),
                "feed": feed.stats(), "feeders": ctx.mgr.get("feed_stats"),
                "pin": dict(infeed.pin_stats),
                "launches": ops.launch_counts(),
                "feed_wait_s": feed.wait_s,
                "main_start_wall": main_start_wall,
                "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                                if cuda else None)}, f)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--width", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--model_dir", default="segmentation_model")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    p.add_argument("--num_gpus", type=int, default=0)
    args = p.parse_args()

    from tensorflowonspark_tpu_torch import TFCluster, configure_logging
    from tensorflowonspark_tpu_torch.engine import LocalEngine
    from tensorflowonspark_tpu_torch.examples.segmentation import (
        synthetic_pets,
    )

    configure_logging()
    images, masks = synthetic_pets(args.batch_size * args.steps,
                                   hw=args.image_size)
    records = list(zip(list(images), list(masks)))
    engine = LocalEngine(args.cluster_size)
    try:
        cluster = TFCluster.run(
            engine, main_fun,
            {"batch_size": args.batch_size, "lr": args.lr,
             "width": args.width,
             "model_dir": os.path.abspath(args.model_dir),
             "device": args.device},
            num_executors=args.cluster_size,
            input_mode=TFCluster.InputMode.SPARK, master_node="chief",
            num_gpus=args.num_gpus)
        cluster.train(engine.parallelize(records, args.cluster_size * 2))
        cluster.shutdown(grace_secs=5)
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
