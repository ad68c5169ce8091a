"""PyTorch port under a pyspark SparkContext, on the CPU: the
``SparkEngine``/``SparkDataset`` adapter, barrier placement,
``TFCluster`` over Spark with ``inference()``, and ``spark_ml``'s
``Pipeline([TFEstimator]).fit(df)`` -> ``TFModel.transform(df)`` (the
JAX package's ``tests/test_spark_integration.py`` cases, on the port).

Without pyspark, ``import pyspark`` resolves to ``tests/sparkstub``, the
test double whose executors are processes of the JAX package's
``LocalEngine`` (used as it is); with pyspark installed the same tests
run on Spark.  The port's modules import nothing of the JAX package in
those executors either; they reattach to their node by the executor-id
file, as under Spark.  The ``main_fun``s are module-level functions of
this file, which the executors import, so it imports no JAX at the top.
"""

import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

STUB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "sparkstub")
W1, W2 = 3.14, 1.618
TIMEOUT = 60


def _have_real_pyspark():
    try:
        import pyspark  # noqa: F401

        return "sparkstub" not in os.path.dirname(pyspark.__file__)
    except ImportError:
        return False


@pytest.fixture(scope="module")
def spark():
    """A SparkContext (real if installed, the stub otherwise), 2
    executors."""
    added = False
    if not _have_real_pyspark() and STUB_DIR not in sys.path:
        sys.path.insert(0, STUB_DIR)
        added = True
    importlib.invalidate_caches()
    import pyspark

    conf = pyspark.SparkConf().set("spark.executor.instances", "2")
    if _have_real_pyspark():
        conf.setMaster(os.environ.get("MASTER", "local[2]"))
        conf.setAppName("tfos-torch-tests")
    sc = pyspark.SparkContext(conf=conf)
    yield sc
    sc.stop()
    if added:
        sys.path.remove(STUB_DIR)
        for name in [m for m in sys.modules if m.split(".")[0] == "pyspark"]:
            del sys.modules[name]
        sys.modules.pop("tensorflowonspark_tpu_torch.spark_ml", None)


def _executor_label(it):
    list(it)
    return [os.environ.get("TFOS_EXECUTOR_INDEX", "real-spark")]


def test_as_engine_wraps_sparkcontext(spark):
    from tensorflowonspark_tpu_torch.engine import (
        SparkDataset,
        SparkEngine,
        as_dataset,
        as_engine,
    )

    eng = as_engine(spark)
    assert isinstance(eng, SparkEngine)
    assert eng.num_executors == 2
    assert eng.default_fs.startswith("file")
    ds = eng.parallelize(range(10), 2)
    assert isinstance(ds, SparkDataset) and ds.num_partitions == 2
    assert as_dataset(spark.parallelize(range(3), 1)).collect() == [0, 1, 2]
    assert sorted(ds.union(ds).collect()) == sorted(list(range(10)) * 2)


def test_dynamic_allocation_raises(spark):
    from tensorflowonspark_tpu_torch.engine import SparkEngine

    class _Conf:
        def get(self, key, default=None):
            return "true" if key == "spark.dynamicAllocation.enabled" \
                else default

    class _Ctx:
        def getConf(self):
            return _Conf()

    with pytest.raises(RuntimeError, match="dynamicAllocation"):
        SparkEngine(_Ctx())


def test_spread_uses_barrier_slots(spark):
    """``spread=True`` schedules one concurrent task a slot
    (``rdd.barrier()``)."""
    from tensorflowonspark_tpu_torch.engine import as_dataset

    out = as_dataset(spark.parallelize(range(2), 2)).map_partitions(
        _executor_label).collect(spread=True)
    assert len(out) == 2
    if not _have_real_pyspark():
        assert sorted(out) == ["0", "1"], "tasks must land on distinct slots"


def _jax_loaded(it):
    list(it)
    return [any(m == "jax" or m.startswith("jax.") for m in sys.modules)]


def squares_fn(args, ctx):
    data = ctx.get_data_feed(train_mode=False)
    while not data.should_stop():
        batch = data.next_batch(100)
        if batch:
            data.batch_results([x * x for x in batch])


def test_cluster_inference_on_spark(spark):
    """The reference's functional baseline through ``TFCluster`` over a
    SparkContext: the squares of 0..999, each once, in order."""
    from tensorflowonspark_tpu_torch import cluster as TFCluster

    cluster = TFCluster.run(spark, squares_fn, [], num_executors=2,
                            input_mode=TFCluster.InputMode.SPARK,
                            reservation_timeout=TIMEOUT)
    out = cluster.inference(spark.parallelize(range(1000), 4),
                            feed_timeout=TIMEOUT).collect()
    cluster.shutdown()
    assert out == [x * x for x in range(1000)]
    # the port's node, feeder and shutdown tasks ran in these executors
    # without bringing JAX in
    from tensorflowonspark_tpu_torch.engine import as_dataset

    assert as_dataset(spark.parallelize(range(2), 2)).map_partitions(
        _jax_loaded).collect(spread=True) == [False, False]


def linreg_main(args, ctx):
    """Trains y = w.x from the feed's dense columns over the gloo group;
    the chief exports."""
    from tensorflowonspark_tpu_torch import infeed
    from tensorflowonspark_tpu_torch.models import linear
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    env = ctx.torch_initialize("cpu")
    params = linear.init_params(device="cpu")
    leaves = [p.requires_grad_() for p in params.values()]
    step = linear.make_train_step(torch.optim.SGD(leaves, lr=0.5))
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping=args.input_mapping)
    per_proc = args.batch_size // env["num_processes"]

    def collate(cols):
        return (torch.from_numpy(np.asarray(cols["features"], np.float32)),
                torch.from_numpy(np.asarray(cols["label"], np.float32)))

    for x, y in infeed.synchronized(infeed.device_feed(
            feed, per_proc, collate=collate, placement="cpu",
            columnar=True), feed=feed):
        step(params, x, y)
    ckpt.export_model(args.export_dir, linear.params_to_jax(params), ctx,
                      metadata={"predict": linear.PREDICT})


def test_spark_ml_pipeline_fit_transform(spark, tmp_path):
    """``Pipeline(stages=[TFEstimator]).fit(df)`` ->
    ``PipelineModel.stages[0].transform(df)``: a DataFrame whose
    ``preds`` are w1 + w2 to 2 decimals."""
    from pyspark.ml import Pipeline
    from pyspark.sql import SparkSession

    from tensorflowonspark_tpu_torch.spark_ml import TFEstimator, TFModel

    session = SparkSession(spark)
    rng = np.random.default_rng(42)
    x = rng.random((1024, 2)).astype(np.float32)
    y = x @ np.array([W1, W2], dtype=np.float32)
    df = session.createDataFrame(
        [(list(map(float, xi)), float(yi)) for xi, yi in zip(x, y)],
        schema=["x", "y"])
    est = (TFEstimator(linreg_main, {"device": "cpu"})
           .setInputMapping({"x": "features", "y": "label"})
           .setClusterSize(2).setMasterNode("chief").setEpochs(12)
           .setBatchSize(32).setExportDir(str(tmp_path / "export"))
           .setGraceSecs(0))
    model = Pipeline(stages=[est]).fit(df).stages[0]
    assert isinstance(model, TFModel)
    infer_df = session.createDataFrame([([1.0, 1.0],)] * 8, schema=["x"])
    preds_df = (model.copy().setInputMapping({"x": "features"})
                .setOutputMapping({"prediction": "preds"}).setBatchSize(4)
                .transform(infer_df))
    assert "preds" in preds_df.columns
    preds = preds_df.collect()
    assert len(preds) == 8
    for row in preds:
        assert round(float(row.preds), 2) == round(W1 + W2, 2)
