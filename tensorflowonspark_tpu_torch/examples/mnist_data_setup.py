"""Prepare MNIST-shaped data as CSV and TFRecord shards.

Counterpart of ``examples/mnist/mnist_data_setup.py``.  With no network,
a seeded synthetic set with learnable structure is generated (the JAX
example's generator); ``--from_csv`` converts a real MNIST CSV dump
(``label,pix0,...,pix783`` a line) instead::

    python -m tensorflowonspark_tpu_torch.examples.mnist_data_setup \\
        --output mnist_data
    # -> mnist_data/csv/part-00000 ...  mnist_data/tfr/part-r-00000 ...

Unlike the JAX script, which writes its TFRecords as one shard, the
TFRecords go into ``--num_partitions`` part files, as the CSV does:
``mnist_tf_ds`` gives each rank its own part files, and a single shard
would feed one rank only.  Each record is ``{"image": 784 floats in
[0, 1], "label": int}``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def synthetic_mnist(n, seed=0):
    """(images [n, 28, 28, 1] float32 in [0, 1), labels [n] int32 0..7):
    the label is the brightest quadrant times two, plus whether the
    whole image is bright."""
    rng = np.random.default_rng(seed)
    images = rng.random((n, 28, 28, 1), dtype=np.float32)
    q = np.stack([images[:, :14, :14, 0].mean((1, 2)),
                  images[:, :14, 14:, 0].mean((1, 2)),
                  images[:, 14:, :14, 0].mean((1, 2)),
                  images[:, 14:, 14:, 0].mean((1, 2))], axis=-1)
    labels = (np.argmax(q, axis=-1) * 2 + (q.sum(-1) > 2.0)).astype(np.int32)
    return images, labels


def load_csv_dir(csv_dir):
    """(images, labels) of a CSV directory of ``label,pix...`` lines."""
    rows = []
    for fname in sorted(os.listdir(csv_dir)):
        with open(os.path.join(csv_dir, fname)) as f:
            for line in f:
                vals = np.array(line.split(","), dtype=np.float32)
                rows.append((vals[1:].reshape(28, 28, 1) / 255.0,
                             int(vals[0])))
    images = np.stack([r[0] for r in rows]).astype(np.float32)
    labels = np.asarray([r[1] for r in rows], dtype=np.int32)
    return images, labels


def write_shards(images, labels, output, num_partitions):
    """The CSV shards under ``output/csv`` and the TFRecord shards under
    ``output/tfr``, ``num_partitions`` contiguous slices each.  Returns
    the two directories."""
    from tensorflowonspark_tpu_torch import dfutil, recordio

    csv_dir = os.path.join(output, "csv")
    tfr_dir = os.path.join(output, "tfr")
    os.makedirs(csv_dir, exist_ok=True)
    os.makedirs(tfr_dir, exist_ok=True)
    per = (len(images) + num_partitions - 1) // num_partitions
    for shard in range(num_partitions):
        lo, hi = shard * per, min((shard + 1) * per, len(images))
        with open(os.path.join(csv_dir, f"part-{shard:05d}"), "w") as f:
            for i in range(lo, hi):
                pix = ",".join(str(int(v)) for v in
                               (images[i].ravel() * 255).astype(np.int64))
                f.write(f"{labels[i]},{pix}\n")
        path = os.path.join(tfr_dir, f"part-r-{shard:05d}")
        with recordio.TFRecordWriter(path) as w:
            for i in range(lo, hi):
                w.write(dfutil.to_example(
                    {"image": [float(v) for v in images[i].ravel()],
                     "label": int(labels[i])}))
    return csv_dir, tfr_dir


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--output", default="mnist_data")
    p.add_argument("--num_examples", type=int, default=2048)
    p.add_argument("--num_partitions", type=int, default=4)
    p.add_argument("--from_csv", default=None,
                   help="an MNIST CSV dir to convert instead of synthetic")
    args = p.parse_args()
    if args.from_csv:
        images, labels = load_csv_dir(args.from_csv)
    else:
        images, labels = synthetic_mnist(args.num_examples)
    csv_dir, tfr_dir = write_shards(images, labels, args.output,
                                    args.num_partitions)
    print(f"wrote {len(images)} examples: {csv_dir} and {tfr_dir}")


if __name__ == "__main__":
    main()
