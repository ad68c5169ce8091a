"""Batch-inference CLI: TFRecords -> ``TFModel`` -> JSON lines.

Counterpart of ``tensorflowonspark_tpu/inference.py``: parse the
arguments, load the TFRecords (``dfutil.load_tfrecords``, with an
optional schema hint, ``utils.schema``), run the cached-model
``pipeline.TFModel.transform`` in the engine's executors, and write
each partition's predictions as a JSON-lines shard::

    tfos-inference-torch \\
        --export_dir /path/export \\
        --input /path/tfrecords --output /path/preds \\
        --schema_hint 'struct<image:array<float>,label:bigint>' \\
        --input_mapping '{"image": "x"}' \\
        --output_mapping '{"prediction": "pred"}'

The predict runs on the card (``--device``, default the card; ``cpu``
for the CPU), in the executors of a ``LocalEngine`` this command starts
(``--num_executors``), or of the engine ``run(args, source=...)`` is
given (a ``LocalEngine`` or a pyspark ``SparkContext``).  Each executor
then holds a CUDA context (``pipeline``'s note).  The partition
functions are module-level classes, shipped with plain ``pickle``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import uuid

logger = logging.getLogger(__name__)


def build_parser():
    p = argparse.ArgumentParser(
        prog="tfos-inference-torch",
        description="Batch inference over TFRecords with an exported model")
    p.add_argument("--export_dir", required=True,
                   help="export directory (utils.checkpoint.export_model)")
    p.add_argument("--input", required=True, help="TFRecord dir or file")
    p.add_argument("--output", required=True, help="output dir (JSON lines)")
    p.add_argument("--schema_hint", default=None,
                   help="struct<name:type,...> partial schema hint")
    p.add_argument("--input_mapping", default=None,
                   help="JSON {column: tensor_name}")
    p.add_argument("--output_mapping", default=None,
                   help="JSON {tensor_name: column}")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--no_pad_partial", dest="pad_partial",
                   action="store_false", default=True,
                   help="do not pad the last partial batch up to "
                        "--batch_size (padding keeps one input shape; the "
                        "padded rows are cut off the outputs)")
    p.add_argument("--signature_def_key", default=None,
                   help="module:function predict override")
    p.add_argument("--num_executors", type=int, default=2,
                   help="LocalEngine pool size (ignored under Spark)")
    p.add_argument("--device", default=None,
                   help="where the predict runs: default the card, 'cpu' "
                        "for the CPU")
    return p


def run(args, source=None):
    """Run the CLI's job; returns the JSON shards' paths.  ``source``:
    the engine to run on (default a ``LocalEngine`` of
    ``args.num_executors``, stopped at the end)."""
    from tensorflowonspark_tpu_torch import dfutil, pipeline
    from tensorflowonspark_tpu_torch.engine import LocalEngine, as_engine
    from tensorflowonspark_tpu_torch.recordio import fs
    from tensorflowonspark_tpu_torch.utils import schema as schema_util

    hint = schema_util.parse_schema(args.schema_hint) if args.schema_hint \
        else {}
    binary_features = [n for n, (k, _) in hint.items() if k == "bytes"]
    own_engine = source is None
    engine = (LocalEngine(num_executors=args.num_executors) if own_engine
              else as_engine(source))
    try:
        ds, inferred = dfutil.load_tfrecords(engine, args.input,
                                             binary_features=binary_features)
        schema = schema_util.merge_schemas(inferred, hint)
        logger.info("input schema: %s", schema_util.format_schema(schema))
        input_mapping = (json.loads(args.input_mapping)
                         if args.input_mapping else None)
        output_mapping = (json.loads(args.output_mapping)
                          if args.output_mapping else None)
        # ML Params win over tf_args, as the JAX CLI sets them;
        # pad_partial and device are plain tf_args
        model = pipeline.TFModel({"pad_partial": args.pad_partial,
                                  "device": args.device})
        settings = {"export_dir": args.export_dir,
                    "batch_size": args.batch_size,
                    "input_mapping": input_mapping,
                    "output_mapping": output_mapping,
                    "signature_def_key": args.signature_def_key}
        model._set(**{k: v for k, v in settings.items() if v is not None})
        if input_mapping:
            ds = ds.map_partitions(_Project(sorted(input_mapping)))
        preds = model.transform(ds)
        fs.makedirs(args.output)
        shards = [s for s in preds.map_partitions(
            _WriteJson(args.output)).collect() if s]
        logger.info("wrote %d shards under %s", len(shards), args.output)
        return shards
    finally:
        if own_engine:
            engine.stop()


class _Project:
    """Row dicts -> tuples of ``cols``, in order."""

    def __init__(self, cols):
        self.cols = list(cols)

    def __call__(self, it):
        return [tuple(row[c] for c in self.cols) for row in it]


class _WriteJson:
    """A partition's prediction dicts -> one JSON-lines shard under
    ``output_dir``; returns its path (nothing for an empty partition)."""

    def __init__(self, output_dir):
        self.output_dir = output_dir

    def __call__(self, it):
        from tensorflowonspark_tpu_torch.recordio import fs

        rows = list(it)
        if not rows:
            return []
        # unique even when one executor writes several partitions
        path = fs.join(self.output_dir,
                       f"part-{os.getpid()}-{uuid.uuid4().hex[:8]}.json")
        with fs.open_file(path, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        return [path]


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
