"""TFRecord <-> row-table interop.

The port's own copy of ``tensorflowonspark_tpu/dfutil.py``: rows are
plain dicts, converted to ``tf.train.Example`` TFRecords and back with a
schema inferred from the first record (a ``binary_features`` hint tells
bytes from strings), through the port's record IO (``recordio``) on
local or remote paths (``recordio.fs``).  ``load_tfrecords`` parallelises *read units*
``(path, stride, offset)`` and reads them in the executors through the
engine's ``map_partitions`` lineage, so no record passes through the
driver; ``load_tfrecords_columnar`` and ``iter_tfrecords_columnar`` are
the bulk column loaders of ``InputMode.TENSORFLOW``.  The functions
that the engine ships (``read_shard``, ``write_partition``) are
module-level classes, which plain ``pickle`` carries.

Type mapping:
  int/bool      -> int64_list        float         -> float_list
  str           -> bytes_list(utf8)  bytes         -> bytes_list
  list[...]     -> the element kind's list (an array in the schema)
"""

from __future__ import annotations

import logging
import os
import uuid

import numpy as np

from tensorflowonspark_tpu_torch import engine as _engine
from tensorflowonspark_tpu_torch import recordio
from tensorflowonspark_tpu_torch.engine import as_dataset
from tensorflowonspark_tpu_torch.recordio import fs as _fs

logger = logging.getLogger(__name__)

# provenance of the datasets loaded in this process: {input_dir: schema}
loaded_schemas = {}


# -- row <-> Example ----------------------------------------------------------

def to_example(row: dict) -> bytes:
    """Encode one row dict as a serialized tf.train.Example."""
    feats = {}
    for name, value in row.items():
        is_list = isinstance(value, (list, tuple))
        vals = list(value) if is_list else [value]
        if not vals:
            feats[name] = ("float", [])
        elif isinstance(vals[0], bool):
            feats[name] = ("int64", [int(v) for v in vals])
        elif isinstance(vals[0], int):
            feats[name] = ("int64", vals)
        elif isinstance(vals[0], float):
            feats[name] = ("float", vals)
        elif isinstance(vals[0], str):
            feats[name] = ("bytes", [v.encode() for v in vals])
        elif isinstance(vals[0], (bytes, bytearray)):
            feats[name] = ("bytes", [bytes(v) for v in vals])
        elif isinstance(vals[0], np.integer):
            feats[name] = ("int64", [int(v) for v in vals])
        elif isinstance(vals[0], np.floating):
            feats[name] = ("float", [float(v) for v in vals])
        elif isinstance(vals[0], np.ndarray):
            arr = np.asarray(vals[0])
            if arr.dtype.kind in "iu":
                feats[name] = ("int64", [int(x) for x in arr.ravel()])
            else:
                feats[name] = ("float", [float(x) for x in arr.ravel()])
        else:
            raise TypeError(f"unsupported type for {name}: {type(vals[0])}")
    return recordio.encode_example(feats)


def infer_schema(example_bytes: bytes, binary_features=()):
    """{name: (kind, is_array)} from one record: an array where a feature
    holds more than one value; bytes read as str unless named in
    ``binary_features``."""
    feats = recordio.decode_example(example_bytes)
    schema = {}
    for name, (kind, values) in feats.items():
        if kind == "bytes" and name not in binary_features:
            kind = "string"
        schema[name] = (kind, len(values) > 1)
    return schema


def from_example(example_bytes: bytes, schema=None, binary_features=()):
    """Decode a serialized Example into a row dict."""
    feats = recordio.decode_example(example_bytes)
    if schema is None:
        schema = infer_schema(example_bytes, binary_features)
    row = {}
    for name, (kind, values) in feats.items():
        skind, is_array = schema.get(name, (kind, len(values) > 1))
        if skind == "string":
            values = [v.decode() for v in values]
        row[name] = list(values) if is_array else (values[0] if values
                                                   else None)
    return row


# -- save / load --------------------------------------------------------------

def _write_shard(rows, path):
    with recordio.TFRecordWriter(path) as w:
        for row in rows:
            w.write(to_example(row))


class write_partition:  # noqa: N801 - the JAX package's closure's name
    """The ``map_partitions`` stage of :func:`save_as_tfrecords`: write
    the partition's rows as one shard under ``output_dir`` and return
    its path (nothing for an empty partition)."""

    def __init__(self, output_dir):
        self.output_dir = output_dir

    def __call__(self, it):
        rows = list(it)
        if not rows:
            return []
        # unique even when one executor writes several shards in a row
        shard = _fs.join(self.output_dir,
                         f"part-r-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        _write_shard(rows, shard)
        return [shard]


def save_as_tfrecords(dataset_or_rows, output_dir):
    """Write rows as TFRecord shards under ``output_dir``: one
    ``part-r-*`` file a partition of an engine dataset, written in the
    executors and gathered with ``collect``, or ``part-r-00000`` for a
    plain list of rows.  Returns ``output_dir``."""
    _fs.makedirs(output_dir)
    try:
        ds = as_dataset(dataset_or_rows)
    except TypeError:
        _write_shard(dataset_or_rows, _fs.join(output_dir, "part-r-00000"))
        return output_dir
    shards = ds.map_partitions(write_partition(output_dir)).collect()
    logger.info("saved %d shards under %s", len(shards), output_dir)
    return output_dir


def part_files(input_dir):
    """The shards of a TFRecord directory (its sorted ``part-*`` files,
    ``.tmp`` spill left out), or ``[input_dir]`` for a single file."""
    files = sorted(
        _fs.join(input_dir, f)
        for f in _fs.listdir(input_dir)
        if f.startswith("part-") and not f.endswith(".tmp")
    ) if _fs.isdir(input_dir) else [input_dir]
    if not files:
        raise FileNotFoundError(f"no TFRecord part files under {input_dir}")
    return files


class read_shard:  # noqa: N801 - the JAX package's closure's name
    """The ``map_partitions`` stage of :func:`load_tfrecords`: the row
    dicts of a partition of read units.  A unit is a path, or
    ``(path, stride, offset)``, which keeps the records whose index in
    the file is ``offset`` modulo ``stride``."""

    def __init__(self, schema, binary_features=()):
        self.schema = schema
        self.binary_features = tuple(binary_features)

    def __call__(self, it):
        out = []
        for unit in it:
            path, stride, offset = (unit if isinstance(unit, tuple)
                                    else (unit, 1, 0))
            for i, rec in enumerate(recordio.TFRecordReader(path)):
                if stride == 1 or i % stride == offset:
                    out.append(from_example(rec, self.schema,
                                            self.binary_features))
        # the codec that read them, for the feeder's stats in an executor
        _engine.task_report["codec"] = recordio.codec()
        return out


def load_tfrecords(source, input_dir, binary_features=(),
                   min_partitions=None):
    """TFRecords as a dataset of row dicts, and the schema inferred from
    the first record: ``(dataset, schema)``.

    ``source``: a ``LocalEngine``, whose dataset reads the shards in the
    executors (``read_shard`` through ``map_partitions``); or None for
    ``(list of rows, schema)`` read here.

    ``min_partitions``: where the directory has fewer shard files than
    this, each file is striped across ``ceil(min_partitions / files)``
    read units ``(path, stride, offset)``; each unit scans its whole
    file (TFRecords have no index) and keeps its share, so fewer shards
    than workers starve no feeder and nothing passes through the
    driver.  The dataset has ``min(units, max(2 * executors,
    min_partitions))`` partitions of contiguous units, in file order."""
    files = part_files(input_dir)
    first = next(iter(recordio.TFRecordReader(files[0])))
    schema = infer_schema(first, binary_features)
    reader = read_shard(schema, binary_features)
    loaded_schemas[input_dir] = schema
    if source is None:
        return reader(iter(files)), schema
    if min_partitions and len(files) < min_partitions:
        stripes = -(-min_partitions // len(files))  # ceil
        units = [(f, stripes, off) for f in files for off in range(stripes)]
        logger.info("striping %d shard file(s) into %d read units to reach "
                    "min_partitions=%d (each unit rescans its file, keeping "
                    "1/%d of the records)", len(files), len(units),
                    min_partitions, stripes)
    else:
        units = list(files)
    n_parts = min(len(units),
                  max(source.num_executors * 2, min_partitions or 0))
    return source.parallelize(units, n_parts).map_partitions(reader), schema


def load_tfrecords_columnar(source):
    """Bulk-load TFRecords into dense per-feature columns: {name: ndarray
    [n] or [n, w], or a list of bytes}, one C pass a shard.

    ``source``: a directory (its part files), a file, or a list of paths
    (one worker's shards).  Empty shards are skipped; dtype or width
    drift across shards raises."""
    files = source if isinstance(source, (list, tuple)) \
        else part_files(source)
    pairs = [(f, s) for f in files
             if (s := recordio.load_columnar(f))]  # skip empty parts
    if not pairs:
        return {}
    sig = _columnar_signature(pairs[0][1])
    for f, s in pairs[1:]:
        if _columnar_signature(s) != sig:
            raise ValueError(f"shard {f} schema {_columnar_signature(s)} "
                             f"!= first shard's {sig}")
    out = {}
    for name, (_kind, col) in pairs[0][1].items():
        parts = [col] + [s[name][1] for _, s in pairs[1:]]
        if isinstance(col, np.ndarray):
            out[name] = np.concatenate(parts, axis=0)
        else:
            out[name] = [v for p in parts for v in p]
    return out


def _columnar_signature(shard):
    """name -> (kind, dtype, trailing shape): drift across shards must
    raise, not upcast under np.concatenate.  A list (bytes) column is
    "flat" (one value a record), "nested" (several) or "ragged" (both),
    read over the whole column."""

    def sig(kind, col):
        if isinstance(col, np.ndarray):
            return (kind, col.dtype.name, col.shape[1:])
        n_lists = sum(1 for v in col if isinstance(v, list))
        shape = ("flat" if n_lists == 0
                 else "nested" if n_lists == len(col) else "ragged")
        return (kind, "list", shape)

    return {name: sig(kind, col) for name, (kind, col) in shard.items()}


def iter_tfrecords_columnar(source, batch_size, *, drop_remainder=False):
    """Dense column batches from TFRecords, one shard resident at a time:
    {name: ndarray [b] or [b, w], or a list of bytes}.

    ``source``: a directory, a file, or a list of paths.  Every batch has
    ``batch_size`` rows but a short last one (dropped with
    ``drop_remainder=True``); rows come in shard order, empty shards are
    skipped, and drift across shards raises."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    files = source if isinstance(source, (list, tuple)) \
        else part_files(source)

    def concat(parts):
        if isinstance(parts[0], np.ndarray):
            return parts[0] if len(parts) == 1 else np.concatenate(parts)
        return [v for p in parts for v in p]

    sig = None
    rest = None  # {name: partial column} carried into the next shard
    for f in files:
        shard = recordio.load_columnar(f)
        if not shard:
            continue
        shard_sig = _columnar_signature(shard)
        if sig is None:
            sig = shard_sig
        elif shard_sig != sig:
            raise ValueError(
                f"shard {f} schema {shard_sig} != first shard's {sig}")
        cols = {name: col for name, (_k, col) in shard.items()}
        if rest:
            cols = {name: concat([rest[name], cols[name]]) for name in cols}
        n = len(next(iter(cols.values())))
        lo = 0
        while n - lo >= batch_size:
            yield {name: col[lo:lo + batch_size]
                   for name, col in cols.items()}
            lo += batch_size
        # copy ndarray remainders: a view would pin the whole shard until
        # the next shard's concatenation
        rest = ({name: (col[lo:].copy() if isinstance(col, np.ndarray)
                        else col[lo:])
                 for name, col in cols.items()}
                if lo < n else None)
    if rest and not drop_remainder:
        yield rest


def is_loaded_df(path):
    """True if ``path`` was loaded by :func:`load_tfrecords` in this
    process."""
    return path in loaded_schemas


# the JAX package's camelCase spellings, so ported call sites work as
# they are
saveAsTFRecords = save_as_tfrecords
loadTFRecords = load_tfrecords
toTFExample = to_example
fromTFExample = from_example
inferSchema = infer_schema
isLoadedDF = is_loaded_df
