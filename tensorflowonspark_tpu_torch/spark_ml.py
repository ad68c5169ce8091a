"""``pyspark.ml`` stages over the port's pipeline.

Counterpart of ``tensorflowonspark_tpu/spark_ml.py``: ``TFEstimator`` and
``TFModel`` are a ``pyspark.ml`` ``Estimator`` and ``Model`` that wrap
``pipeline.TFEstimator`` and ``pipeline.TFModel`` (which hold the
Params, the cluster launch and the cached-model inference) and add only
the Spark ML contract: ``Estimator._fit(DataFrame) -> Model`` and
``Model._transform(DataFrame) -> DataFrame``::

    from tensorflowonspark_tpu_torch.spark_ml import TFEstimator
    est = TFEstimator(main_fun, args).setClusterSize(2).setEpochs(1)
    model = Pipeline(stages=[est]).fit(df)
    preds = model.transform(df)

Importing it needs pyspark.  The function that turns the predictions
into Rows is a module-level class (``_ToRows``), as every function the
port ships to executors is.
"""

from __future__ import annotations

import copy as _copy
import logging

from pyspark.ml import Estimator as _SparkEstimator
from pyspark.ml import Model as _SparkModel

from tensorflowonspark_tpu_torch import pipeline as _pipeline

logger = logging.getLogger(__name__)


class _DelegatesParams:
    """The ``setX``/``getX`` surface and Params introspection go to the
    wrapped pipeline object; setters return the Spark stage, so chains
    stay on it."""

    _impl = None

    def __getattr__(self, name):
        impl = object.__getattribute__(self, "_impl")
        if impl is None:
            raise AttributeError(name)
        attr = getattr(impl, name)
        if name.startswith("set") and callable(attr):
            def chaining_setter(*a, _attr=attr, **kw):
                _attr(*a, **kw)
                return self

            return chaining_setter
        return attr

    @property
    def params(self):
        return self._impl.params

    def extractParamMap(self, extra=None):  # noqa: N802 - pyspark's name
        out = self._impl.extractParamMap()
        out.update(extra or {})
        return out

    def getOrDefault(self, param):  # noqa: N802
        return self._impl.getOrDefault(param)

    def isDefined(self, param):  # noqa: N802
        return self._impl.isDefined(param)

    def copy(self, extra=None):
        dup = _copy.copy(self)
        dup._impl = self._impl.copy(
            {(k.name if hasattr(k, "name") else k): v
             for k, v in (extra or {}).items()})
        return dup


class TFEstimator(_DelegatesParams, _SparkEstimator):
    """A ``pyspark.ml.Estimator`` that trains through ``cluster.run`` on
    the DataFrame's SparkContext and returns a :class:`TFModel`."""

    def __init__(self, train_fn, tf_args=None, export_fn=None):
        super().__init__()
        self._impl = _pipeline.TFEstimator(train_fn, tf_args, export_fn)

    def _fit(self, dataset):
        return TFModel._wrap(self._impl.fit(dataset))


class _ToRows:
    """A ``mapPartitions`` function: prediction dicts -> ``Row``s of
    ``cols`` (every key, sorted, when ``cols`` is empty)."""

    def __init__(self, cols):
        self.cols = tuple(cols)

    def __call__(self, it):
        from pyspark.sql import Row

        rows = []
        for d in it:
            cols = list(self.cols) if self.cols else sorted(d)
            rows.append(Row(**{c: d[c] for c in cols}))
        return rows


class TFModel(_DelegatesParams, _SparkModel):
    """A ``pyspark.ml.Model`` whose ``transform`` predicts with the
    cached model in each executor and returns a DataFrame of the
    ``output_mapping`` columns (the pipeline's note on CUDA in executors
    holds here too)."""

    def __init__(self, tf_args=None):
        super().__init__()
        self._impl = _pipeline.TFModel(tf_args)

    @classmethod
    def _wrap(cls, impl):
        m = cls.__new__(cls)
        _SparkModel.__init__(m)
        m._impl = impl
        return m

    def _transform(self, dataset):
        from pyspark.sql import SparkSession

        out_ds = self._impl.transform(dataset)
        args = self._impl.merge_args_params()
        out_cols = ([c for _, c in sorted(args.output_mapping.items())]
                    if args.get("output_mapping") else None)
        row_rdd = out_ds.rdd.mapPartitions(_ToRows(out_cols or ()))
        session = getattr(dataset, "sparkSession", None) or \
            SparkSession.builder.getOrCreate()
        return session.createDataFrame(row_rdd, schema=out_cols)
