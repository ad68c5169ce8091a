"""MNIST parallel inference: N independent single-node workers, no
cluster.

Counterpart of ``examples/mnist/mnist_inference.py``, over
``parallel_run``: each worker loads the export once onto its device,
scores its share of the TFRecord part files
(``[task_index::num_workers]``) and writes ``label prediction`` lines to
``<output>/part-<task>``::

    python -m tensorflowonspark_tpu_torch.examples.mnist_data_setup \\
        --output mnist_data
    python -m tensorflowonspark_tpu_torch.examples.mnist_tf_ds \\
        --data_dir mnist_data/tfr --model_dir mnist_model   # the export
    python -m tensorflowonspark_tpu_torch.examples.mnist_inference \\
        --data_dir mnist_data/tfr --export_dir mnist_model/export

Default: the card; ``--device cpu`` for the CPU.  An export whose
metadata names the JAX package's MNIST predict is served by the port's
(``serving.replicas.JAX_PREDICTS``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def infer_fun(args, ctx):
    """Runs in every worker; returns the predictions it wrote."""
    import sys

    from tensorflowonspark_tpu_torch import dfutil, recordio
    from tensorflowonspark_tpu_torch.serving import replicas
    from tensorflowonspark_tpu_torch.utils.checkpoint import load_exported

    tree, meta = load_exported(args["export_dir"])
    predict = replicas._import_qualname(meta["predict"])
    convert = getattr(sys.modules[predict.__module__], "params_from_jax",
                      None)
    params = (convert(tree, device=args.get("device")) if convert
              else tree)
    files = dfutil.part_files(args["data_dir"])[
        ctx.task_index::ctx.num_workers]
    os.makedirs(args["output"], exist_ok=True)
    out_path = os.path.join(args["output"], f"part-{ctx.task_index:05d}")
    n = 0
    with open(out_path, "w") as out:
        for path in files:
            images, labels = [], []
            for rec in recordio.TFRecordReader(path):
                feats = recordio.decode_example(rec)
                images.append(np.asarray(feats["image"][1], np.float32))
                labels.append(int(feats["label"][1][0]))
            if not images:
                continue
            res = predict(params, {"x": np.stack(images)},
                          device=args.get("device"))
            for lbl, pred in zip(labels, res["prediction"]):
                out.write(f"{lbl} {int(pred)}\n")
                n += 1
    return n


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--data_dir", default="mnist_data/tfr")
    p.add_argument("--export_dir", default="mnist_model/export")
    p.add_argument("--output", default="mnist_predictions")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    p.add_argument("--num_gpus", type=int, default=0)
    args = p.parse_args()

    from tensorflowonspark_tpu_torch import parallel_run
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    engine = LocalEngine(args.cluster_size)
    try:
        counts = parallel_run.run(
            engine, infer_fun,
            {"data_dir": os.path.abspath(args.data_dir),
             "export_dir": os.path.abspath(args.export_dir),
             "output": os.path.abspath(args.output), "device": args.device},
            num_executors=args.cluster_size, num_gpus=args.num_gpus)
    finally:
        engine.stop()
    print(f"wrote {sum(counts)} predictions to {args.output}")


if __name__ == "__main__":
    main()
