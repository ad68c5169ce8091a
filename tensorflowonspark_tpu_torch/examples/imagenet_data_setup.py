"""One-time ImageNet data prep: JPEG TFRecord shards -> raw uint8 ones.

Counterpart of ``examples/resnet/imagenet_data_setup.py``: decode once,
in parallel across the engine's executors (one task per input shard),
and train from fixed-size raw records that skip the decode::

    python -m tensorflowonspark_tpu_torch.examples.imagenet_data_setup \\
        --input_dir /data/imagenet-jpeg-tfr --output_dir /data/imagenet-raw \\
        --image_size 224 --num_executors 8

Input shards may use either layout ``imagenet_records`` understands
(TF-official ``"image/encoded"`` JPEG/PNG bytes and 1-based
``"image/class/label"``, or ``"image"`` and ``"label"``).  Output shards
always hold ``"image"`` (raw uint8 HWC bytes) and a 0-based ``"label"``,
one output shard per input shard of the same name, byte for byte what
the JAX tool writes; ``resnet_imagenet_spark --data_dir <output_dir>``
then reads them without decoding.  Paths may be local or remote
(``recordio.fs``).  Under ``spark-submit`` the Spark cluster does the
decode, else a ``LocalEngine``.
"""

from __future__ import annotations

import argparse
import os


def convert_shard(in_path, out_path, image_size):
    """Decode one input shard into raw records; returns ``(records,
    skipped)``.  A record is valid when ``imagenet_records.decode_record``
    (the definition the training example uses) accepts it; an invalid
    one is skipped and counted, never written with a default label or as
    raw-baked compressed bytes."""
    from tensorflowonspark_tpu_torch import recordio
    from tensorflowonspark_tpu_torch.examples import imagenet_records

    n = skipped = 0
    with recordio.TFRecordWriter(out_path) as w:
        for rec in recordio.TFRecordReader(in_path):
            feats = {k: v for k, (_kind, v)
                     in recordio.decode_example(rec).items()}
            try:
                arr, label = imagenet_records.decode_record(feats,
                                                            image_size)
            except (KeyError, ValueError) as e:
                if skipped < 3:
                    print(f"  skipping record in "
                          f"{os.path.basename(in_path)}: {e}", flush=True)
                skipped += 1
                continue
            w.write(recordio.encode_example({
                "image": ("bytes", [arr.tobytes()]),
                "label": ("int64", [int(label)]),
            }))
            n += 1
    return n, skipped


class convert_partition:  # noqa: N801 - the JAX tool's closure's name
    """The engine job: a partition of ``(input shard, output shard)``
    pairs -> ``[(shard name, records, skipped)]``."""

    def __init__(self, image_size):
        self.image_size = image_size

    def __call__(self, it):
        return [(os.path.basename(src),) + convert_shard(src, dst,
                                                         self.image_size)
                for src, dst in it]


def convert(engine, input_dir, output_dir, image_size, num_partitions):
    """Convert every shard of ``input_dir`` into ``output_dir`` on
    ``engine``, in at most ``num_partitions`` tasks; returns the sorted
    ``(shard name, records, skipped)`` of each."""
    from tensorflowonspark_tpu_torch import dfutil
    from tensorflowonspark_tpu_torch.recordio import fs

    files = dfutil.part_files(input_dir)
    fs.makedirs(output_dir)
    jobs = [(f, fs.join(output_dir, os.path.basename(f))) for f in files]
    ds = engine.parallelize(jobs, min(len(jobs), num_partitions))
    return sorted(ds.map_partitions(convert_partition(image_size))
                  .collect())


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_executors", type=int, default=4)
    args = p.parse_args()

    from tensorflowonspark_tpu_torch.engine import LocalEngine, SparkEngine

    try:  # under spark-submit: the Spark cluster does the decode
        from pyspark import SparkContext

        engine = SparkEngine(SparkContext.getOrCreate())
    except ImportError:
        engine = LocalEngine(args.num_executors)
    try:
        results = convert(engine, args.input_dir, args.output_dir,
                          args.image_size, args.num_executors * 2)
    finally:
        engine.stop()
    total = sum(r[1] for r in results)
    skipped = sum(r[2] for r in results)
    for name, n, sk in results:
        print(f"  {name}: {n} records" + (f" ({sk} skipped)" if sk else ""))
    print(f"wrote {total} raw {args.image_size}px records in "
          f"{len(results)} shard(s) under {args.output_dir}"
          + (f"; skipped {skipped}" if skipped else ""))


if __name__ == "__main__":
    main()
