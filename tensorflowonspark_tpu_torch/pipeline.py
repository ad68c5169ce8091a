"""ML-pipeline layer: ``TFEstimator`` and ``TFModel`` with typed Params.

Counterpart of ``tensorflowonspark_tpu/pipeline.py``.  ``TFEstimator.fit``
starts a cluster (``cluster.run``), feeds it the dataset under
``InputMode.SPARK`` (or exports it as TFRecords for an
``InputMode.TENSORFLOW`` main), shuts it down and returns a ``TFModel``
with the estimator's params; ``TFModel.transform`` predicts with an
export directory (``utils/checkpoint.export_model``), one cached model a
process, batch by batch over each partition.  The Params machinery
(``Param``, ``TypeConverters``, ``Params``, the ``Has*`` mixins,
``Namespace``, ``TFParams``) needs no pyspark; ``spark_ml`` wraps these
classes as ``pyspark.ml`` stages.

Differences from the JAX package:

- Plain ``pickle``: the partition functions are module-level classes
  (``_RunModel``, ``_SelectColumns``), whose cache is this module's
  ``_model_cache`` in the process that runs them.
- The predict runs where the ``device`` tf_arg says, default the card:
  ``predict(params, inputs, device=...)``, as ``serving.ModelSpec``
  calls it.  Without a CUDA device and without ``device="cpu"`` the
  transform raises; it never predicts on the CPU instead.  The export's
  params go to the device once a cache entry, not once a batch: when
  the predict's module has ``params_from_jax(tree, device=)`` (MNIST,
  linear regression), the entry holds its result, and the predict uses
  the tensors where they are.
- An export whose metadata names a JAX predict
  (``tensorflowonspark_tpu.models.mnist:predict``) gets the port's
  counterpart (``serving.replicas.JAX_PREDICTS``), so a JAX-made export
  transforms here.
- ``num_gpus`` (``HasNumGpus``) takes the place of ``num_chips``.
- There is no ``jax.jit``: the predict runs eagerly.  ``pad_partial``
  (a tf_arg, default True) still pads the last partial batch to
  ``batch_size``, so every call has one shape.

**CUDA in executors.**  ``transform`` predicts inside the executor that
runs the partition (``map_partitions``), so on a card that executor
then holds a CUDA context.  A trainer forked from such an executor
cannot use CUDA, so a later ``fit`` (or any ``InputMode.SPARK``
cluster) on the same engine is refused by the node at once
(``node.run``).  Transform on an engine of its own, or fit first.
"""

from __future__ import annotations

import argparse
import copy as _copy
import logging
import os
import sys
import time

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Spark-ML-style Params machinery (no pyspark)
# ---------------------------------------------------------------------------

class Param:
    """A typed, documented parameter owned by a Params class."""

    def __init__(self, name, doc, converter=None):
        self.name = name
        self.doc = doc
        self.converter = converter

    def __repr__(self):
        return f"Param({self.name})"


class TypeConverters:
    """Coercions for Param values (pyspark's, and ``toDict``)."""

    @staticmethod
    def toInt(v):  # noqa: N802 - pyspark's names
        return int(v)

    @staticmethod
    def toFloat(v):  # noqa: N802
        return float(v)

    @staticmethod
    def toString(v):  # noqa: N802
        return str(v)

    @staticmethod
    def toBoolean(v):  # noqa: N802
        if isinstance(v, str):
            return v.lower() in ("1", "true", "yes")
        return bool(v)

    @staticmethod
    def toDict(v):  # noqa: N802
        if not isinstance(v, dict):
            raise TypeError(f"expected dict, got {type(v)}")
        return v


class Params:
    """A param map with defaults, with the surface of
    ``pyspark.ml.param.Params`` that the estimator and model use
    (``_set``, ``_setDefault``, ``getOrDefault``, ``extractParamMap``,
    ``copy``)."""

    def __init__(self):
        self._paramMap = {}
        self._defaultParamMap = {}
        self._init_mixin_defaults()

    @property
    def params(self):
        out = []
        for klass in type(self).__mro__:
            for val in vars(klass).values():
                if isinstance(val, Param):
                    out.append(val)
        return out

    def _param(self, name):
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(f"no param {name} on {type(self).__name__}")

    def _set(self, **kwargs):
        for name, value in kwargs.items():
            p = self._param(name)
            if value is not None and p.converter is not None:
                value = p.converter(value)
            self._paramMap[p] = value
        return self

    def _setDefault(self, **kwargs):  # noqa: N802 - pyspark's name
        for name, value in kwargs.items():
            self._defaultParamMap[self._param(name)] = value
        return self

    def isDefined(self, param):  # noqa: N802
        p = self._param(param) if isinstance(param, str) else param
        return p in self._paramMap or p in self._defaultParamMap

    def getOrDefault(self, param):  # noqa: N802
        p = self._param(param) if isinstance(param, str) else param
        if p in self._paramMap:
            return self._paramMap[p]
        return self._defaultParamMap[p]

    def extractParamMap(self):  # noqa: N802
        out = dict(self._defaultParamMap)
        out.update(self._paramMap)
        return out

    def copy(self, extra=None):
        dup = _copy.copy(self)
        dup._paramMap = dict(self._paramMap)
        dup._defaultParamMap = dict(self._defaultParamMap)
        for key, value in (extra or {}).items():
            # Param objects or plain names ({'epochs': 3})
            dup._set(**{key.name if isinstance(key, Param) else key: value})
        return dup

    def _init_mixin_defaults(self):
        """Install the default of every Has* mixin in this class's MRO
        (the one init path: mixins define no ``__init__``, so subclasses
        with their own ``__init__`` signatures are never re-invoked)."""
        for klass in type(self).__mro__:
            pname = vars(klass).get("_mixin_param")
            if pname is not None:
                self._setDefault(**{pname: vars(klass)["_mixin_default"]})


def _mixin(name, doc, converter, default=None):
    """A Has<Name> mixin: the Param, a setter and a getter.  Params
    without an explicit default default to None."""

    def snake_to_camel(s):
        return "".join(w.capitalize() for w in s.split("_"))

    param = Param(name, doc, converter)

    def _setter(self, value):
        return self._set(**{name: value})

    def _getter(self):
        return self.getOrDefault(name)

    return type(f"Has{snake_to_camel(name)}", (Params,), {
        name: param,
        "_mixin_param": name,
        "_mixin_default": default,
        f"set{snake_to_camel(name)}": _setter,
        f"get{snake_to_camel(name)}": _getter,
    })


HasBatchSize = _mixin("batch_size", "Number of records per batch",
                      TypeConverters.toInt, 128)
HasClusterSize = _mixin("cluster_size", "Number of nodes in the cluster",
                        TypeConverters.toInt, 1)
HasEpochs = _mixin("epochs", "Number of epochs to train",
                   TypeConverters.toInt, 1)
HasGraceSecs = _mixin(
    "grace_secs",
    "Seconds to wait after feeding (for final tasks like model export)",
    TypeConverters.toInt, 30)
HasInputMapping = _mixin("input_mapping",
                         "Mapping of input column to input tensor",
                         TypeConverters.toDict)
HasInputMode = _mixin("input_mode",
                      "Input feeding mode (0=TENSORFLOW, 1=SPARK)",
                      TypeConverters.toInt, 1)
HasMasterNode = _mixin("master_node", "Job name of the master/chief node",
                       TypeConverters.toString, "chief")
HasModelDir = _mixin("model_dir", "Path to save/load model checkpoints",
                     TypeConverters.toString)
HasExportDir = _mixin("export_dir", "Directory to export the model",
                      TypeConverters.toString)
HasOutputMapping = _mixin("output_mapping",
                          "Mapping of output tensor to output column",
                          TypeConverters.toDict)
HasProtocol = _mixin(
    "protocol", "Network protocol (accepted for compatibility; the process "
    "group picks its own)", TypeConverters.toString, "grpc")
HasReaders = _mixin("readers", "Number of reader/enqueue threads",
                    TypeConverters.toInt, 1)
HasSteps = _mixin("steps", "Maximum number of steps to train",
                  TypeConverters.toInt, 1000)
HasTensorboard = _mixin("tensorboard", "Launch TensorBoard on the chief node",
                        TypeConverters.toBoolean, False)
HasTFRecordDir = _mixin(
    "tfrecord_dir", "Path to temporarily export a DataFrame as TFRecords "
    "(InputMode.TENSORFLOW apps)", TypeConverters.toString)
HasSignatureDefKey = _mixin(
    "signature_def_key",
    "Identifier of the exported predict function (overrides export "
    "metadata)", TypeConverters.toString)
HasTagSet = _mixin("tag_set",
                   "Comma-delimited tags identifying an export variant",
                   TypeConverters.toString)
HasNumPS = _mixin("num_ps", "Number of PS nodes in the cluster",
                  TypeConverters.toInt, 0)
HasDriverPSNodes = _mixin("driver_ps_nodes", "Run PS nodes on the driver",
                          TypeConverters.toBoolean, False)
HasNumGpus = _mixin("num_gpus", "GPUs claimed per executor",
                    TypeConverters.toInt, 0)


class Namespace:
    """Unifies a dict, an argv list and an ``argparse.Namespace``:
    attribute access, plus ``argv`` for mains that re-parse it."""

    def __init__(self, d=None, **kwargs):
        self.argv = None
        if isinstance(d, list):
            self.argv = list(d)
        elif isinstance(d, dict):
            self.__dict__.update(d)
        elif isinstance(d, Namespace):
            self.__dict__.update(vars(d))
            self.argv = d.argv
        elif isinstance(d, argparse.Namespace):
            self.__dict__.update(vars(d))
        elif d is not None:
            raise TypeError(f"unsupported args type: {type(d)}")
        self.__dict__.update(kwargs)

    def __contains__(self, key):
        return key in self.__dict__

    def __getitem__(self, key):
        return self.__dict__[key]

    def __iter__(self):
        return iter(self.__dict__)

    def items(self):
        return {k: v for k, v in self.__dict__.items() if k != "argv"}.items()

    def get(self, key, default=None):
        return self.__dict__.get(key, default)

    def __repr__(self):
        return f"Namespace({self.__dict__})"


class TFParams(Params):
    """Current Param values folded over the user's args (params win)."""

    args = None

    def merge_args_params(self):
        args = Namespace(self.args)
        for param, value in self.extractParamMap().items():
            setattr(args, param.name, value)
        return args


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------

class TFEstimator(TFParams, HasBatchSize, HasClusterSize, HasEpochs,
                  HasGraceSecs, HasInputMapping, HasInputMode,
                  HasMasterNode, HasModelDir, HasExportDir, HasNumPS,
                  HasDriverPSNodes, HasNumGpus, HasProtocol, HasReaders,
                  HasSteps, HasTensorboard, HasTFRecordDir):
    """Trains a model on a dataset and returns a :class:`TFModel`.

    ``train_fn(args, ctx)`` is the user's main (a module-level function:
    executors import it), ``args`` this estimator's tf_args with its
    params over them; ``export_fn(args)`` an optional hook the driver
    calls after the cluster stopped."""

    def __init__(self, train_fn, tf_args=None, export_fn=None):
        Params.__init__(self)
        self.train_fn = train_fn
        self.export_fn = export_fn
        self.args = Namespace(tf_args if tf_args is not None else {})

    def fit(self, dataset, params=None):
        if params:
            return self.copy(params).fit(dataset)
        return self._fit(dataset)

    def _fit(self, dataset):
        from tensorflowonspark_tpu_torch import cluster as tfcluster

        args = self.merge_args_params()
        logger.info("fit: args=%s", args)
        engine, feed_ds = _dataset_and_engine(dataset)
        if args.input_mode == tfcluster.InputMode.TENSORFLOW:
            if not args.tfrecord_dir:
                raise ValueError("InputMode.TENSORFLOW requires tfrecord_dir "
                                 "for the dataset's TFRecord export")
            from tensorflowonspark_tpu_torch import dfutil

            logger.info("exporting dataset to %s", args.tfrecord_dir)
            dfutil.save_as_tfrecords(feed_ds, args.tfrecord_dir)
        elif args.input_mapping:
            # feed columns in tensor-name order, the order in which
            # DataFeed unpacks them
            input_cols = [col for col, _t in sorted(
                args.input_mapping.items(), key=lambda kv: kv[1])]
            feed_ds = _select_columns(feed_ds, input_cols)

        cluster = tfcluster.run(
            engine, self.train_fn, args, num_executors=args.cluster_size,
            num_ps=args.num_ps, driver_ps_nodes=args.driver_ps_nodes,
            tensorboard=args.tensorboard, input_mode=args.input_mode,
            master_node=args.master_node, num_gpus=args.num_gpus)
        if args.input_mode == tfcluster.InputMode.SPARK:
            cluster.train(feed_ds, args.epochs)
        cluster.shutdown(grace_secs=args.grace_secs)

        if self.export_fn:
            if not args.export_dir:
                raise ValueError("export_fn requires export_dir")
            self.export_fn(args)

        # the shared params carry over; the model's own (output_mapping,
        # signature_def_key, tag_set) keep their defaults
        model = TFModel(self.args)
        names = {p.name for p in model.params}
        model._defaultParamMap.update(
            {p: v for p, v in self._defaultParamMap.items()
             if p.name in names})
        model._paramMap.update(
            {p: v for p, v in self._paramMap.items() if p.name in names})
        return model


# ---------------------------------------------------------------------------
# Model: cached batch inference, one model a process
# ---------------------------------------------------------------------------

# (export_dir, signature_def_key, device) -> _CacheEntry, in the process
# that runs the partitions
_model_cache = {}


class _CacheEntry:
    """A loaded model: the predict, its params (on ``device`` when the
    predict's module converts them), and what it did in this process."""

    def __init__(self, predict, params, device):
        self.predict = predict
        self.params = params
        self.device = device
        self.loads = 1
        self.batches = 0
        self.rows = 0
        self.predict_ms = 0.0

    def stats(self):
        return {"loads": self.loads, "batches": self.batches,
                "rows": self.rows, "predict_ms": self.predict_ms}


class TFModel(TFParams, HasBatchSize, HasInputMapping, HasOutputMapping,
              HasModelDir, HasExportDir, HasSignatureDefKey, HasTagSet):
    """Transforms a dataset with an exported model, one cached model a
    process (see the module's note on CUDA in executors)."""

    def __init__(self, tf_args=None):
        Params.__init__(self)
        self.args = Namespace(tf_args if tf_args is not None else {})

    def transform(self, dataset, params=None):
        """A dataset of one dict a row, ``{output column: value}``, in
        the input's order, lazily: collect it to run it.  Rows are
        projected onto ``sorted(input_mapping)`` first."""
        if params:
            return self.copy(params).transform(dataset)
        args = self.merge_args_params()
        if not (args.get("export_dir") or args.get("model_dir")):
            raise ValueError("TFModel requires export_dir or model_dir")
        logger.info("transform: args=%s", args)
        ds = _as_dataset(dataset)
        if args.input_mapping:
            ds = _select_columns(ds, sorted(args.input_mapping))
        return ds.map_partitions(_RunModel(args))

    def as_service(self, num_replicas=None, watch_model_dir=True, **kw):
        """This model as an online service: a ``serving.Server`` of the
        same export and predict resolution (``signature_def_key``
        overrides), on the ``device`` tf_arg (default the card), with
        checkpoint hot reload from ``model_dir`` when
        ``watch_model_dir``.  Other keywords (``max_batch``,
        ``max_delay_ms``, ``queue_max``, ``engine``, ...) go to
        ``Server``; the caller starts and stops it."""
        from tensorflowonspark_tpu_torch import serving

        args = self.merge_args_params()
        export_dir = args.get("export_dir")
        model_dir = args.get("model_dir")
        if not (export_dir or model_dir):
            raise ValueError("as_service requires export_dir or model_dir")
        spec = serving.ModelSpec(
            export_dir=export_dir,
            ckpt_dir=model_dir if watch_model_dir else None,
            predict=args.get("signature_def_key"),
            device=args.get("device"))
        return serving.Server(spec, num_replicas=num_replicas, **kw)


class _RunModel:
    """The transform's partition function: the cached model predicts the
    partition batch by batch; rows go to columns and back through
    ``recordio.marshal``."""

    def __init__(self, args):
        self.args = args

    def __call__(self, iterator):
        import numpy as np

        from tensorflowonspark_tpu_torch.recordio import marshal
        from tensorflowonspark_tpu_torch.serving import batcher

        args = self.args
        input_tensors = ([v for _, v in sorted(args.input_mapping.items())]
                         if args.get("input_mapping") else None)
        out_pairs = (sorted(args.output_mapping.items())
                     if args.get("output_mapping") else None)
        export_dir = args.get("export_dir") or args.model_dir
        device = args.get("device")
        key = (export_dir, args.get("signature_def_key"), device)
        entry = _model_cache.get(key)
        if entry is None:
            entry = _model_cache[key] = _load_predictor(export_dir, args)
            logger.info("loaded model %s into this process's cache", key)
        batch_size = args.batch_size
        results = []
        for batch in yield_batch(iterator, batch_size):
            if input_tensors is None:
                inputs = {"inputs": np.asarray(batch)}
            else:
                cols = (marshal.rows_to_columns(batch)
                        if isinstance(batch[0], (tuple, list))
                        else (np.asarray(batch),))
                inputs = {t: cols[i] for i, t in enumerate(input_tensors)}
            n = len(batch)
            if n < batch_size and args.get("pad_partial", True):
                inputs = batcher.pad_columns(inputs, batch_size)
            t0 = time.perf_counter()
            outputs = entry.predict(entry.params, inputs, device=device)
            if not isinstance(outputs, dict):
                name = out_pairs[0][0] if out_pairs else "outputs"
                outputs = {name: outputs}
            # the padded rows are cut off: only the first n are real
            outputs = {k: np.asarray(v)[:n] for k, v in outputs.items()}
            entry.predict_ms += 1e3 * (time.perf_counter() - t0)
            entry.batches += 1
            entry.rows += n
            for k, v in outputs.items():
                if len(v) != n:
                    raise ValueError(f"output {k} has {len(v)} rows for "
                                     f"{n} input rows")
            names = ([t for t, _ in out_pairs] if out_pairs
                     else sorted(outputs))
            out_names = [c for _, c in out_pairs] if out_pairs else names
            for row in marshal.columns_to_rows([outputs[t] for t in names]):
                results.append(dict(zip(out_names, row)))
        return results


def _load_predictor(export_dir, args):
    """A :class:`_CacheEntry` of an export directory: the predict named
    by ``signature_def_key`` or the export's metadata ("module:qualname";
    the JAX package's names map to the port's), and the params, put on
    the device here when the predict's module has ``params_from_jax``."""
    from tensorflowonspark_tpu_torch.serving import replicas
    from tensorflowonspark_tpu_torch.utils.checkpoint import load_exported

    params, meta = load_exported(export_dir)
    spec = args.get("signature_def_key") or meta.get("predict")
    if not spec:
        raise ValueError(
            f"export {export_dir} has no 'predict' metadata; set "
            "signature_def_key='module:function' on the TFModel")
    fn = replicas._import_qualname(spec)
    device = args.get("device")
    convert = getattr(sys.modules.get(getattr(fn, "__module__", "")),
                      "params_from_jax", None)
    if convert is not None:
        params = convert(params, device=device)
    return _CacheEntry(fn, params, device)


def model_cache_stats(it):
    """A ``map_partitions`` function that reports this process's model
    cache: ``[{"pid", "peak_mem_bytes", "entries": [(key, stats)]}]``.
    Collect it with ``spread=True`` to read every executor's."""
    list(it)
    peak = None
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        peak = torch.cuda.max_memory_allocated()
    return [{"pid": os.getpid(), "peak_mem_bytes": peak,
             "entries": [(list(k), e.stats())
                         for k, e in _model_cache.items()]}]


def yield_batch(iterator, batch_size):
    """Lists of at most ``batch_size`` items of ``iterator``."""
    batch = []
    for item in iterator:
        batch.append(item)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


# ---------------------------------------------------------------------------
# dataset plumbing
# ---------------------------------------------------------------------------

def _as_dataset(dataset):
    """A dataset of an engine dataset, an ``(engine, rows)`` pair, a
    pyspark DataFrame or an RDD."""
    from tensorflowonspark_tpu_torch.engine import as_dataset

    if isinstance(dataset, tuple) and len(dataset) == 2:
        engine, rows = dataset
        return engine.parallelize(rows) if isinstance(rows, list) else rows
    cls = type(dataset)
    if cls.__module__.startswith("pyspark.sql") and \
            cls.__name__ == "DataFrame":
        dataset = dataset.rdd
    return as_dataset(dataset)


def _dataset_and_engine(dataset):
    """``(engine, dataset)``: as :func:`_as_dataset`, with the engine
    that owns the dataset, which ``fit`` starts its cluster on."""
    from tensorflowonspark_tpu_torch.engine import LocalDataset, SparkEngine

    if isinstance(dataset, tuple) and len(dataset) == 2:
        engine, rows = dataset
        return engine, (engine.parallelize(rows) if isinstance(rows, list)
                        else rows)
    ds = _as_dataset(dataset)
    if isinstance(ds, LocalDataset):
        return ds._engine, ds
    return SparkEngine(ds.rdd.context), ds


class _SelectColumns:
    """A ``map_partitions`` function projecting rows (dicts, Spark Rows,
    or tuples already in order) onto tuples of ``cols``."""

    def __init__(self, cols):
        self.cols = list(cols)

    def __call__(self, it):
        cols = self.cols
        out = []
        for row in it:
            if isinstance(row, dict):
                out.append(tuple(row[c] for c in cols))
            elif hasattr(row, "asDict"):
                d = row.asDict()
                out.append(tuple(d[c] for c in cols))
            elif isinstance(row, (tuple, list)) and len(row) == len(cols):
                out.append(tuple(row))
            else:
                raise TypeError(
                    f"cannot project columns {cols} from row {row!r}; rows "
                    "must be dicts, Rows, or pre-ordered tuples of "
                    "matching arity")
        return out


def _select_columns(ds, cols):
    return ds.map_partitions(_SelectColumns(cols))
