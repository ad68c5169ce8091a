"""ResNet-50 on ImageNet-shaped records, InputMode.SPARK: the north-star
workload.

Counterpart of ``examples/resnet/resnet_imagenet_spark.py``: uint8
(224, 224, 3) records stream through each executor's ``DataFeed`` into
``infeed.device_feed(columnar=True)`` and a bf16 ResNet-50 step with f32
master weights and BN statistics, ``SGD(0.1, momentum 0.9)``, resume from
the newest checkpoint under ``model_dir/ckpt`` and chief saves in the
JAX package's npz format.  ``chip_smoke.py`` drives it at full size on
the card.  Without Spark, on the built-in engine, with synthetic images::

    python -m tensorflowonspark_tpu_torch.examples.resnet_imagenet_spark \\
        --cluster_size 1 --num_gpus 1 --batch_size 256 --steps 20

ImageNet TFRecords (``--data_dir``) wait for ROADMAP.md queue 1, item 8.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

TFRECORD_ITEM = "ROADMAP.md queue 1, item 8"


def synthetic_records(n, image_size=224, num_classes=1000, seed=0):
    """``n`` (uint8 [image_size, image_size, 3], label) rows over a pool
    of 32 seeded images, as the JAX example's ``_records`` makes them
    without ``--data_dir``."""
    rng = np.random.default_rng(seed)
    pool = [rng.integers(0, 256, (image_size, image_size, 3), dtype=np.uint8)
            for _ in range(32)]
    return [(pool[i % len(pool)], int(i % num_classes)) for i in range(n)]


def main_fun(args, ctx):
    """Runs in every trainer.  ``args``: ``batch_size`` (global), ``lr``,
    ``image_size``, ``num_classes``, ``model_dir``; optional
    ``save_every`` (200), ``accum_steps`` (1), ``device`` (default the
    card), ``compute_dtype`` (``"bfloat16"``), ``seed`` (0, for the
    params when no checkpoint exists) and ``out_dir``, where each rank
    writes ``resnet_imagenet-rank<r>.json``: its losses, step times
    (CUDA events on a card), records its ``DataFeed`` handed out,
    ``TrainMetrics`` report, feed wait, peak device memory, the step it
    resumed from, and the wall-clock times at which it began, had its
    model and began its first step."""
    main_start_wall = time.time()
    import torch

    from tensorflowonspark_tpu_torch import infeed
    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt
    from tensorflowonspark_tpu_torch.utils.metrics import TrainMetrics

    env = ctx.torch_initialize(args.get("device"))
    dev = env["device"]
    image = args["image_size"]
    params, state = resnet.init(
        torch.Generator(device=dev).manual_seed(args.get("seed", 0)),
        depth=50, num_classes=args["num_classes"], device=dev)
    leaves = [p.requires_grad_() for p in resnet.param_leaves(params)]
    opt = torch.optim.SGD(leaves, lr=args["lr"], momentum=0.9)

    ckpt_dir = os.path.join(args["model_dir"], "ckpt")
    restored, step = ckpt.restore_latest(ckpt_dir)
    if restored is not None:
        resnet.restore_checkpoint_tree(restored, params, state, opt)
    start_step = step
    step_fn = resnet.make_train_step(
        opt, depth=50, accum_steps=args.get("accum_steps", 1),
        compute_dtype=getattr(torch, args.get("compute_dtype", "bfloat16")))
    model_wall = time.time()

    per_proc = args["batch_size"] // max(env["num_processes"], 1)
    tm = TrainMetrics(flops_per_item=3 * resnet.flops_per_image(50, image),
                      device=dev)
    feed_tm = TrainMetrics()  # accumulates the DataFeed's waits
    feed = ctx.get_data_feed(train_mode=True, metrics=feed_tm,
                             input_mapping={"image": "image",
                                            "label": "label"})

    def collate(cols):
        # uint8 HWC records; the step casts them to the compute dtype on
        # the card, unnormalised, as the JAX model does
        imgs = np.asarray(cols["image"], dtype=np.uint8).reshape(
            -1, image, image, 3)
        return imgs, np.asarray(cols["label"], dtype=np.int64)

    def save(step):
        ckpt.save_checkpoint(ckpt_dir,
                             resnet.checkpoint_tree(params, state, opt), step)

    # synchronized: every process stops on the same step at the end of
    # the feed, whatever its ragged tail
    batches = iter(infeed.synchronized(infeed.device_feed(
        feed, per_proc, collate=collate, depth=2, columnar=True,
        placement=dev), feed=feed))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, first_step_wall = [], [], None
    while True:
        # the host's wait for the next staged batch: infeed_stall_frac
        t_wait = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            break
        if losses:
            tm.infeed_wait(time.perf_counter() - t_wait)
        else:
            first_step_wall = time.time()
        imgs, labels = batch
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        loss, acc, state = step_fn(params, state, imgs, labels)
        if cuda:
            end.record()
        losses.append(loss.item())  # waits for the step
        if cuda:
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        else:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        step += 1
        tm.step(items=len(labels) * env["num_processes"], loss=losses[-1])
        if step % 20 == 0 and env["process_id"] == 0:
            r = tm.report()
            print(f"step {step}: loss={losses[-1]:.4f} "
                  f"acc={float(acc):.3f} "
                  f"img/s={r.get('items_per_sec', 0):.0f} "
                  f"mfu={r.get('mfu', 0):.3f} "
                  f"stall={r['infeed_stall_frac']:.3f}", flush=True)
        if step % args.get("save_every", 200) == 0 and ckpt.is_chief(ctx):
            save(step)

    if ckpt.is_chief(ctx):
        save(step)
        r = tm.report()
        print(f"final: step={step} img/s={r.get('items_per_sec', 0):.0f} "
              f"mfu={r.get('mfu', 0):.3f} "
              f"stall={r['infeed_stall_frac']:.3f}", flush=True)
    out_dir = args.get("out_dir")
    if out_dir:
        rank = env["process_id"]
        with open(os.path.join(out_dir, f"resnet_imagenet-rank{rank}.json"),
                  "w") as f:
            json.dump({
                "rank": rank, "pid": os.getpid(), "device": str(dev),
                "losses": losses, "step_ms": step_ms,
                "start_step": start_step, "step": step,
                "records": feed.records, "train_metrics": tm.report(),
                "feed_wait_s": feed_tm.infeed_time,
                "cuda_visible_devices": os.environ.get(
                    "CUDA_VISIBLE_DEVICES"),
                "main_start_wall": main_start_wall,
                "model_wall": model_wall,
                "first_step_wall": first_step_wall,
                "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                                if cuda else None)}, f)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=256,
                   help="global batch (split across workers)")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--steps", type=int, default=20,
                   help="synthetic-data steps")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--save_every", type=int, default=200)
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--data_dir", default=None,
                   help="ImageNet TFRecords (not yet supported)")
    p.add_argument("--model_dir", default="resnet_imagenet_model")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    p.add_argument("--num_gpus", type=int, default=0)
    args = p.parse_args()
    if args.data_dir:
        raise NotImplementedError(f"ImageNet TFRecords come with "
                                  f"{TFRECORD_ITEM}")

    from tensorflowonspark_tpu_torch import cluster as TFCluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    records = synthetic_records(args.batch_size * args.steps,
                                args.image_size, args.num_classes)
    engine = LocalEngine(args.cluster_size)
    try:
        cluster = TFCluster.run(
            engine, main_fun,
            {"batch_size": args.batch_size, "lr": args.lr,
             "image_size": args.image_size,
             "num_classes": args.num_classes,
             "model_dir": os.path.abspath(args.model_dir),
             "save_every": args.save_every,
             "accum_steps": args.accum_steps, "device": args.device},
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
