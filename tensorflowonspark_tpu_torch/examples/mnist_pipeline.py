"""MNIST through the ML pipeline: ``TFEstimator.fit`` -> ``TFModel.transform``.

Counterpart of ``examples/mnist/mnist_pipeline.py``: the estimator
trains over ``InputMode.SPARK`` feeding, the chief exports, and the
model predicts with a cached model in each executor.  Rows are
``{"image": 784 float32s, "label": int}``; the estimator feeds them in
tensor-name order (``input_mapping``) and ``train_fun`` reads them as
dense columns.  On the CPU::

    python -m tensorflowonspark_tpu_torch.examples.mnist_pipeline \\
        --cluster_size 2 --device cpu

Default: the card (``--num_gpus 1`` gives each executor its own).  The
transform runs on a second engine: it predicts inside the executors,
which then hold a CUDA context and could fork no trainer
(``pipeline``'s note).

``infer_fun`` is the trainer of a ``TFCluster.inference()`` job: it
predicts each batch of ``(id, image)`` records it is fed and hands
``(id, prediction, logits)`` back through ``DataFeed.batch_results``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def collate_columns(cols):
    """``{"image": [n, 784], "label": [n]}`` -> (images [n, 28, 28, 1]
    f32, labels [n] int64)."""
    images = np.asarray(cols["image"], np.float32).reshape(-1, 28, 28, 1)
    return images, np.asarray(cols["label"], np.int64)


def collate_rows(records):
    """(image, label) records -> the same as :func:`collate_columns`."""
    return collate_columns({"image": np.stack([r[0] for r in records]),
                            "label": [r[1] for r in records]})


def train_fun(args, ctx):
    """Runs in every trainer.  ``args`` (a ``pipeline.Namespace``):
    ``batch_size`` (global), ``lr``, optional ``device`` (default the
    card), ``seed``, ``input_mapping`` (the feed's columns: ``image`` and
    ``label``; without it the records are (image, label) tuples),
    ``export_dir`` (where the chief exports) and ``out_dir`` (where each
    rank writes ``pipeline-rank<r>.json``: its losses, device, pid, the
    kernels' launches over its steps and its feed's stats)."""
    import torch

    from tensorflowonspark_tpu_torch import infeed, ops
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    env = ctx.torch_initialize(args.get("device"))
    dev = env["device"]
    params = mnist.init_params(
        torch.Generator(device=dev).manual_seed(args.get("seed") or 0),
        device=dev)
    leaves = [p.requires_grad_() for layer in params.values()
              for p in layer.values()]
    step_fn = mnist.make_train_step(
        torch.optim.SGD(leaves, lr=args["lr"], momentum=0.9))
    mapping = args.get("input_mapping")
    feed = ctx.get_data_feed(train_mode=True, input_mapping=mapping)
    per_proc = args["batch_size"] // max(env["num_processes"], 1)
    ops.reset_launch_counts()
    losses = []
    batches = infeed.device_feed(
        feed, per_proc, placement=dev, columnar=mapping is not None,
        collate=collate_columns if mapping is not None else collate_rows)
    for images, labels in infeed.synchronized(batches, feed=feed):
        loss, _ = step_fn(params, images, labels)
        losses.append(float(loss))

    if args.get("export_dir"):
        ckpt.export_model(args["export_dir"], mnist.params_to_jax(params),
                          ctx, metadata={"predict": mnist.PREDICT})
    if args.get("out_dir"):
        rank = env["process_id"]
        with open(os.path.join(args["out_dir"],
                               f"pipeline-rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "losses": losses, "pid": os.getpid(),
                       "device": str(dev), "launches": ops.launch_counts(),
                       "feed": feed.stats()}, f)


def infer_fun(args, ctx):
    """A ``TFCluster.inference()`` trainer: loads ``args["export_dir"]``
    once onto its device, then for each batch of ``(id, image)`` records
    (``input_mapping`` ``{"id": "id", "image": "image"}``) returns
    ``(id, prediction, logits)`` a record.  ``out_dir``: where it writes
    ``infer-rank<r>.json`` (batches, records, predict ms, the kernels'
    launches, peak memory)."""
    import time

    import torch

    from tensorflowonspark_tpu_torch import ops
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    env = ctx.torch_initialize(args.get("device"))
    dev = env["device"]
    tree, _ = ckpt.load_exported(args["export_dir"])
    params = mnist.params_from_jax(tree, device=dev)
    feed = ctx.get_data_feed(train_mode=False,
                             input_mapping={"id": "id", "image": "image"})
    ops.reset_launch_counts()
    batches = records = 0
    predict_ms = 0.0
    while not feed.should_stop():
        cols = feed.next_batch_columns(args["batch_size"])
        if len(cols["id"]) == 0:
            continue
        t0 = time.perf_counter()
        out = mnist.predict(params, {"image": cols["image"]})
        predict_ms += 1e3 * (time.perf_counter() - t0)
        feed.batch_results(list(zip(cols["id"].tolist(),
                                    out["prediction"].tolist(),
                                    out["logits"].tolist())))
        batches += 1
        records += len(cols["id"])
    if args.get("out_dir"):
        rank = env["process_id"]
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
        with open(os.path.join(args["out_dir"], f"infer-rank{rank}.json"),
                  "w") as f:
            json.dump({"rank": rank, "pid": os.getpid(), "device": str(dev),
                       "batches": batches, "records": records,
                       "predict_ms": predict_ms, "peak_mem_bytes": peak,
                       "launches": ops.launch_counts()}, f)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    p.add_argument("--num_gpus", type=int, default=0)
    p.add_argument("--export_dir", default="mnist_pipeline/export")
    args = p.parse_args()

    from tensorflowonspark_tpu_torch import pipeline
    from tensorflowonspark_tpu_torch.engine import LocalEngine
    from tensorflowonspark_tpu_torch.examples.mnist_data_setup import (
        synthetic_mnist,
    )

    images, labels = synthetic_mnist(args.batch_size * args.steps)
    rows = [{"image": img.reshape(-1), "label": int(lbl)}
            for img, lbl in zip(images, labels)]
    export_dir = os.path.abspath(args.export_dir)
    engine = LocalEngine(args.cluster_size)
    try:
        estimator = (
            pipeline.TFEstimator(train_fun, {"lr": args.lr,
                                             "device": args.device})
            .setClusterSize(args.cluster_size)
            .setEpochs(args.epochs)
            .setBatchSize(args.batch_size)
            .setExportDir(export_dir)
            .setInputMapping({"image": "image", "label": "label"})
            .setNumGpus(args.num_gpus)
            .setGraceSecs(0))
        model = estimator.fit(engine.parallelize(rows, args.cluster_size * 2))
    finally:
        engine.stop()

    model = (model.setInputMapping({"image": "x"})
             .setOutputMapping({"prediction": "pred"}))
    test = rows[:256]
    engine = LocalEngine(args.cluster_size)
    try:
        preds = model.transform(engine.parallelize(test, 2)).collect()
    finally:
        engine.stop()
    correct = sum(int(p["pred"]) == r["label"] for p, r in zip(preds, test))
    print(f"accuracy on {len(preds)} training rows: "
          f"{correct / len(preds):.3f}")


if __name__ == "__main__":
    main()
