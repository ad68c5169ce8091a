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

With ``--data_dir``, the records are TFRecord shards of JPEG, PNG or raw
uint8 images (``"image"``/``"label"`` or the TF-official keys,
``imagenet_records``) that each executor reads itself:
``dfutil.load_tfrecords`` ships read units, and the executor reads and
decodes its partition through the engine's ``map_partitions`` lineage
(JPEGs on a pool of ``--decode_threads`` native decoders), so no image
crosses the driver's pipe (``_records``).  ``imagenet_data_setup``
converts JPEG shards to raw ones once, which then skip the decode.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

def synthetic_records(n, image_size=224, num_classes=1000, seed=0):
    """``n`` (uint8 [image_size, image_size, 3], label) rows over a pool
    of 32 seeded images, as the JAX example's ``_records`` makes them
    without ``--data_dir``."""
    rng = np.random.default_rng(seed)
    pool = [rng.integers(0, 256, (image_size, image_size, 3), dtype=np.uint8)
            for _ in range(32)]
    return [(pool[i % len(pool)], int(i % num_classes)) for i in range(n)]


class decode_stream:  # noqa: N801 - the JAX package's closure's name
    """The ``map_partitions`` stage after ``dfutil``'s read: a partition
    of record dicts -> (uint8 [S, S, 3] image, label) rows, decoded
    ``chunk`` records at a time (``imagenet_records``; JPEGs on a pool of
    ``threads``, whose threads have ended before a chunk's rows are
    yielded).  The partition's JPEG decodes, native and through PIL, go
    into the engine's task report (``"jpeg"``), where the feeder reads
    them."""

    def __init__(self, image_size, chunk=256, threads=None):
        self.image_size = image_size
        self.chunk = chunk
        self.threads = threads

    def __call__(self, it):
        from tensorflowonspark_tpu_torch import engine
        from tensorflowonspark_tpu_torch.examples import imagenet_records
        from tensorflowonspark_tpu_torch.recordio import jpeg

        before = jpeg.decode_counts()

        def decoded(batch):
            rows = imagenet_records.decode_records_batch(
                batch, self.image_size, threads=self.threads)
            now = jpeg.decode_counts()
            engine.task_report["jpeg"] = {k: now[k] - before[k]
                                          for k in now}
            return rows

        batch = []
        for rec in it:
            batch.append(rec)
            if len(batch) >= self.chunk:
                yield from decoded(batch)
                batch = []
        if batch:
            yield from decoded(batch)


class decode_block:  # noqa: N801 - a pipeline stage, named as decode_stream
    """A ``data.Pipeline`` ``map`` stage over TFRecord blocks
    (``data.from_tfrecords``): ``{"image": [bytes], "label": int64}`` ->
    ``{"image": uint8 [n, S, S, 3], "label": int64 [n]}``, what the
    trainer reads from the feeder's chunks; raw, JPEG and PNG payloads
    as ``imagenet_records.decode_records_batch`` decodes them (JPEGs on
    a pool of ``threads``).  It runs in the data worker."""

    def __init__(self, image_size, threads=None):
        self.image_size = image_size
        self.threads = threads

    def __call__(self, block):
        from tensorflowonspark_tpu_torch.examples import imagenet_records

        rows = imagenet_records.decode_records_batch(
            [{"image": b, "label": int(y)}
             for b, y in zip(block["image"], block["label"])],
            self.image_size, threads=self.threads)
        return {"image": np.stack([r[0] for r in rows]),
                "label": np.asarray([r[1] for r in rows], np.int64)}


def batch_digest(images, labels):
    """A batch's content digest: sha1 of its image bytes and labels."""
    import hashlib

    h = hashlib.sha1(np.ascontiguousarray(images).tobytes())
    h.update(np.asarray(labels, np.int64).tobytes())
    return h.hexdigest()[:16]


def _records(args, engine):
    """The training rows as an engine dataset: the TFRecords under
    ``args.data_dir``, read and decoded in the executors (shard files
    striped to at least ``args.cluster_size`` partitions, so no feeder
    starves), else ``args.batch_size * args.steps`` synthetic rows in
    ``2 * args.cluster_size`` partitions."""
    if args.data_dir:
        from tensorflowonspark_tpu_torch import dfutil

        ds, _schema = dfutil.load_tfrecords(
            engine, args.data_dir,
            binary_features=("image", "image/encoded"),
            min_partitions=args.cluster_size)
        return ds.map_partitions(decode_stream(
            args.image_size, threads=getattr(args, "decode_threads", None)))
    records = synthetic_records(args.batch_size * args.steps,
                                args.image_size, args.num_classes)
    return engine.parallelize(records, args.cluster_size * 2)


def main_fun(args, ctx):
    """Runs in every trainer.  ``args``: ``batch_size`` (global), ``lr``,
    ``image_size``, ``num_classes``, ``model_dir``; optional
    ``save_every`` (200), ``accum_steps`` (1), ``device`` (default the
    card), ``compute_dtype`` (``"bfloat16"``), ``seed`` (0, for the
    params when no checkpoint exists) and ``out_dir``, where each rank
    writes ``resnet_imagenet-rank<r>.json``: its losses, step times
    (CUDA events on a card), records its ``DataFeed`` handed out and
    what the feed saw (``DataFeed.stats``: transport, columnar chunks,
    pop times; the feeders' timings from the node's KV; the copies into
    pinned memory), the kernels' launches over its steps,
    ``TrainMetrics`` report, feed wait, peak device
    memory, the step it resumed from, and the wall-clock times at which
    it began, had its model and began its first step; with ``digests``,
    each batch's :func:`batch_digest` as the trainer got it.  Its feed
    reads the fields ``image`` and ``label``: the feeder's rows, or the
    data service's chunks of a pipeline ending in :class:`decode_block`."""
    main_start_wall = time.time()
    import torch

    from tensorflowonspark_tpu_torch import infeed, ops
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
    tm = TrainMetrics(flops_per_item=3 * resnet.flops_per_image(50, image),
                      device=dev)
    step_fn = resnet.make_train_step(
        opt, depth=50, accum_steps=args.get("accum_steps", 1),
        compute_dtype=getattr(torch, args.get("compute_dtype", "bfloat16")),
        tm=tm)
    model_wall = time.time()

    per_proc = args["batch_size"] // max(env["num_processes"], 1)
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping={"image": "image",
                                            "label": "label"})

    digests = [] if args.get("digests") else None

    def collate(cols):
        # uint8 HWC records; the step casts them to the compute dtype on
        # the card, unnormalised, as the JAX model does
        imgs = np.asarray(cols["image"], dtype=np.uint8).reshape(
            -1, image, image, 3)
        labels = np.asarray(cols["label"], dtype=np.int64)
        if digests is not None:
            digests.append(batch_digest(imgs, labels))
        return imgs, labels

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
    ops.reset_launch_counts()
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
        tm.step(items=len(labels) * env["num_processes"], loss=losses[-1],
                events=(start, end) if cuda else None)
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
                "feed": feed.stats(), "feeders": ctx.mgr.get("feed_stats"),
                "pin": dict(infeed.pin_stats),
                "launches": ops.launch_counts(),
                "digests": digests,
                "feed_wait_s": feed.wait_s,
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
                   help="synthetic-data steps when --data_dir is absent")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--save_every", type=int, default=200)
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--data_dir", default=None,
                   help="TFRecord dir of JPEG, PNG or raw uint8 images "
                        "(local or remote)")
    p.add_argument("--decode_threads", type=int, default=None,
                   help="JPEG decode threads an executor (default "
                        "min(8, cores))")
    p.add_argument("--model_dir", default="resnet_imagenet_model")
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
             "image_size": args.image_size,
             "num_classes": args.num_classes,
             "model_dir": os.path.abspath(args.model_dir),
             "save_every": args.save_every,
             "accum_steps": args.accum_steps, "device": args.device},
            num_executors=args.cluster_size,
            input_mode=TFCluster.InputMode.SPARK, master_node="chief",
            num_gpus=args.num_gpus)
        cluster.train(_records(args, engine), num_epochs=args.epochs)
        cluster.shutdown()
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
