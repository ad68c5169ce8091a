"""PyTorch port, the ML pipeline on the CPU: the Params machinery held
case by case against the JAX package's, ``TFEstimator.fit`` ->
``TFModel.transform`` of linear regression on a 2-executor gloo engine,
a JAX-made MNIST export transformed to JAX's logits, the model cache,
the refusal to fork a trainer from an executor that holds a CUDA
context, and the card as every new entry point's default.

The ``main_fun``s are module-level functions of this file, which the
executors import, so this file imports no JAX at the top.
"""

import argparse
import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu import pipeline as jax_pipeline  # noqa: E402
from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import pipeline  # noqa: E402
from tensorflowonspark_tpu_torch.engine import (  # noqa: E402
    LocalEngine,
    TaskError,
)

W1, W2 = 3.14, 1.618
TIMEOUT = 60  # seconds: registration, collectives, feed consumption
PACKAGES = {"jax": jax_pipeline, "port": pipeline}
# MNIST logits: the port's transform against JAX's predict, relative to
# the largest logit (float32 convolutions in another order)
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def engine():
    e = LocalEngine(2, env={"OMP_NUM_THREADS": "2"})
    yield e
    e.stop()


# -- the Params machinery, case by case in both packages ----------------------

@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_namespace_from_dict(pkg):
    ns = PACKAGES[pkg].Namespace({"a": 1, "b": "two"})
    assert ns.a == 1 and ns.b == "two"
    assert "a" in ns and "missing" not in ns
    assert dict(ns.items()) == {"a": 1, "b": "two"}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_namespace_from_argv_and_namespace(pkg):
    Namespace = PACKAGES[pkg].Namespace
    ns = Namespace(["--epochs", "3"])
    assert ns.argv == ["--epochs", "3"]
    assert Namespace(Namespace({"x": 9})).x == 9
    assert Namespace(argparse.Namespace(y=7)).y == 7
    with pytest.raises(TypeError):
        Namespace(42)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_params_merge_args_params(pkg):
    est = PACKAGES[pkg].TFEstimator(None, {"batch_size": 17,
                                           "custom": "keep"})
    est.setBatchSize(64).setEpochs(5)
    args = est.merge_args_params()
    assert args.batch_size == 64      # the param wins over the arg
    assert args.epochs == 5
    assert args.custom == "keep"
    assert args.cluster_size == 1     # defaults fill in


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_param_setters_getters_and_copy(pkg):
    m = PACKAGES[pkg].TFModel({})
    m.setBatchSize("32")
    assert m.getBatchSize() == 32
    m.setInputMapping({"x": "features"})
    assert m.getInputMapping() == {"x": "features"}
    with pytest.raises(TypeError):
        m.setInputMapping("not-a-dict")
    dup = m.copy()
    dup.setBatchSize(8)
    assert m.getBatchSize() == 32 and dup.getBatchSize() == 8


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_copy_accepts_string_keys(pkg):
    est = PACKAGES[pkg].TFEstimator(None, {})
    dup = est.copy({"epochs": 7, "batch_size": "16"})
    assert dup.getEpochs() == 7 and dup.getBatchSize() == 16
    assert est.getEpochs() == 1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_estimator_and_model_are_subclassable(pkg):
    mod = PACKAGES[pkg]

    class MyEstimator(mod.TFEstimator):
        def __init__(self, fn):
            super().__init__(fn)
            self.extra = "yes"

    class MyModel(mod.TFModel):
        def __init__(self):
            super().__init__({})

    est = MyEstimator(None)
    assert est.extra == "yes" and est.getBatchSize() == 128
    assert MyModel().getBatchSize() == 128


def test_params_and_defaults_match_the_jax_package():
    """Every Param of both classes, with its default, as the JAX
    package's; ``num_gpus`` (0) takes the place of ``num_chips`` (0)."""
    def defaults(obj):
        return {p.name: v for p, v in obj._defaultParamMap.items()}

    for cls in ("TFEstimator", "TFModel"):
        want = defaults(getattr(jax_pipeline, cls)(None) if cls ==
                        "TFEstimator" else getattr(jax_pipeline, cls)({}))
        got = defaults(getattr(pipeline, cls)(None) if cls ==
                       "TFEstimator" else getattr(pipeline, cls)({}))
        if "num_chips" in want:
            want["num_gpus"] = want.pop("num_chips")
        assert got == want, cls


def test_yield_batch_matches_the_jax_package():
    for n, size in ((10, 4), (8, 4), (0, 3), (5, 10)):
        assert list(pipeline.yield_batch(iter(range(n)), size)) == \
            list(jax_pipeline.yield_batch(iter(range(n)), size))


class _FakeDataset:
    """``map_partitions`` hands back the partition function itself."""

    def map_partitions(self, fn):
        return fn


class _RowLike:
    def __init__(self, d):
        self._d = d

    def asDict(self):  # noqa: N802 - pyspark's name
        return dict(self._d)


@pytest.mark.parametrize("rows", [
    [{"a": 1, "b": 2.0, "c": "x"}],
    [_RowLike({"c": "y", "a": 3, "b": 4.0})],
    [(5, 6.0, "z")],
])
def test_select_columns_matches_the_jax_package(rows):
    cols = ["a", "b", "c"]
    want = jax_pipeline._select_columns(_FakeDataset(), cols)(iter(rows))
    got = pipeline._select_columns(_FakeDataset(), cols)(iter(rows))
    assert got == want


def test_select_columns_rejects_unprojectable_rows(engine):
    ds = engine.parallelize([("only", "two")], 1)
    with pytest.raises(TaskError, match="cannot project"):
        pipeline._select_columns(ds, ["a", "b", "c"]).collect()
    ok = pipeline._select_columns(engine.parallelize([(1, 2)], 1),
                                  ["a", "b"]).collect()
    assert ok == [(1, 2)]
    with pytest.raises(TypeError, match="cannot project"):
        jax_pipeline._select_columns(_FakeDataset(), ["a", "b", "c"])(
            iter([("only", "two")]))


# -- the model cache ----------------------------------------------------------

def _linear_export(path, w=(0.0, 0.0), b=0.0):
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    ckpt.export_model(path, {"w": np.asarray(w, np.float32),
                             "b": np.asarray(b, np.float32)},
                      metadata={"predict":
                                "tensorflowonspark_tpu.models.linear:"
                                "predict"})
    return path


def test_model_cache_loads_once_per_process(tmp_path, monkeypatch):
    """Two tasks unpickled apart, as the engine ships them, share this
    process's cache: the export loads once, its params go to the device
    once, and the JAX predict name resolves to the port's."""
    export_dir = _linear_export(str(tmp_path / "export"), (2.0, 3.0), 1.0)
    args = pipeline.Namespace({
        "export_dir": export_dir, "model_dir": None, "batch_size": 4,
        "input_mapping": {"x": "features"},
        "output_mapping": {"prediction": "preds"},
        "signature_def_key": None, "device": "cpu"})
    pipeline._model_cache.clear()
    loads = []
    real = pipeline._load_predictor
    monkeypatch.setattr(pipeline, "_load_predictor",
                        lambda d, a: loads.append(d) or real(d, a))
    rows = [([1.0, 1.0],)] * 6
    for _ in range(2):
        task = pickle.loads(pickle.dumps(pipeline._RunModel(args)))
        out = task(iter(rows))
        assert [r["preds"] for r in out] == [6.0] * 6
    assert len(loads) == 1
    (entry,) = pipeline._model_cache.values()
    assert isinstance(entry.params["w"], torch.Tensor)
    from tensorflowonspark_tpu_torch.models import linear

    assert entry.predict is linear.predict
    # two partitions of 6 rows at batch 4: two batches each, the second
    # padded to 4 and cut back to 2 rows
    assert entry.stats() == {"loads": 1, "batches": 4, "rows": 12,
                             "predict_ms": entry.predict_ms}
    stats = pipeline.model_cache_stats(iter([0]))
    assert stats[0]["entries"][0][1]["loads"] == 1
    pipeline._model_cache.clear()


# -- fit -> transform: linear regression on a gloo engine ---------------------

def linreg_main(args, ctx):
    """Trains y = w.x + b from the feed's dense columns (gradients
    averaged over the gloo group); the chief exports."""
    from tensorflowonspark_tpu_torch import infeed
    from tensorflowonspark_tpu_torch.models import linear
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    env = ctx.torch_initialize(args.device)
    params = linear.init_params(device=env["device"])
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


def test_estimator_fit_model_transform(engine, tmp_path):
    """The JAX package's reference test, on the port: fit over two gloo
    trainers, transform in the executors; the prediction is w1 + w2 to 2
    decimals, and equals the JAX package's ``linear.predict`` on the
    port's export (1e-6)."""
    rng = np.random.default_rng(42)
    x = rng.random((1024, 2)).astype(np.float32)
    y = x @ np.array([W1, W2], dtype=np.float32)
    rows = [{"x": list(map(float, xi)), "y": float(yi)}
            for xi, yi in zip(x, y)]
    export_dir = str(tmp_path / "export")
    est = (pipeline.TFEstimator(linreg_main, {"device": "cpu"})
           .setInputMapping({"x": "features", "y": "label"})
           .setClusterSize(2).setMasterNode("chief").setEpochs(12)
           .setBatchSize(32).setExportDir(export_dir).setGraceSecs(0))
    model = est.fit(engine.parallelize(rows, 4))
    assert isinstance(model, pipeline.TFModel)
    assert model.getExportDir() == export_dir
    preds = (model.copy().setInputMapping({"x": "features"})
             .setOutputMapping({"prediction": "preds"}).setBatchSize(16)
             .transform(engine.parallelize([{"x": [1.0, 1.0]}] * 8, 2))
             .collect())
    assert len(preds) == 8
    for row in preds:
        assert round(float(row["preds"]), 2) == round(W1 + W2, 2), preds

    from tensorflowonspark_tpu.models import linear as jax_linear
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    params, meta = ckpt.load_exported(export_dir)
    assert meta["predict"] == "tensorflowonspark_tpu_torch.models.linear:" \
        "predict"
    want = jax_linear.predict(params, {"x": np.ones((1, 2), np.float32)})
    np.testing.assert_allclose([preds[0]["preds"]], want, rtol=1e-6)


# -- a JAX-made MNIST export, transformed by the port -------------------------

def test_jax_mnist_export_transforms_to_jax_logits(engine, tmp_path):
    import jax

    from tensorflowonspark_tpu.models import mnist as jax_mnist
    from tensorflowonspark_tpu.utils import checkpoint as jax_ckpt

    export_dir = str(tmp_path / "jax_export")
    params = jax_mnist.init_params(jax.random.PRNGKey(3))
    jax_ckpt.export_model(export_dir, params, metadata={
        "predict": "tensorflowonspark_tpu.models.mnist:predict"})
    images = np.random.default_rng(5).random((40, 784), dtype=np.float32)
    want = jax_mnist.predict(params, {"x": images})
    rows = [{"image": img, "id": i} for i, img in enumerate(images)]
    model = (pipeline.TFModel({"device": "cpu"}).setExportDir(export_dir)
             .setInputMapping({"image": "x"}).setBatchSize(16)
             .setOutputMapping({"logits": "logits", "prediction": "pred"}))
    out = model.transform(engine.parallelize(rows, 2)).collect()
    got = np.asarray([r["logits"] for r in out], np.float32)
    err = np.abs(got - want["logits"]).max() / np.abs(want["logits"]).max()
    assert err <= LOGIT_RTOL, err
    assert [r["pred"] for r in out] == want["prediction"].tolist()


# -- CUDA in an executor ------------------------------------------------------

def _pretend_cuda_context(it):
    """An engine task that makes this executor report a CUDA context, as
    one that ran ``TFModel.transform`` on a card would."""
    list(it)
    torch.cuda.is_initialized = lambda: True


def _noop_main(args, ctx):
    return None


def test_node_refuses_to_fork_a_trainer_after_cuda(tmp_path):
    """On an executor that holds a CUDA context, a SPARK-mode node fails
    at once with the reason, before it starts anything; a TENSORFLOW-mode
    node, which forks no trainer, runs."""
    e = LocalEngine(1, env={"OMP_NUM_THREADS": "1"})
    try:
        e.parallelize([0], 1).foreach_partition(_pretend_cuda_context,
                                                placement=[0])
        with pytest.raises(RuntimeError, match="holds a CUDA context"):
            TFCluster.run(e, _noop_main, {}, 1,
                          input_mode=TFCluster.InputMode.SPARK,
                          reservation_timeout=TIMEOUT)
        c = TFCluster.run(e, _noop_main, {}, 1,
                          input_mode=TFCluster.InputMode.TENSORFLOW,
                          reservation_timeout=TIMEOUT)
        c.shutdown()
    finally:
        e.stop()


# -- the card by default ------------------------------------------------------

def test_new_entry_points_default_to_the_card(tmp_path):
    """Without a CUDA device and without ``device="cpu"``, each new entry
    point raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfied")
    from tensorflowonspark_tpu_torch import inference
    from tensorflowonspark_tpu_torch.examples import mnist_inference
    from tensorflowonspark_tpu_torch.models import linear

    export_dir = _linear_export(str(tmp_path / "export"))
    args = pipeline.Namespace({
        "export_dir": export_dir, "batch_size": 2, "input_mapping": None,
        "output_mapping": None, "signature_def_key": None})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline._RunModel(args)(iter([[1.0, 1.0]]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linear.init_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linear.predict({"w": np.zeros(2), "b": np.zeros(())},
                       {"x": np.ones((1, 2))})
    assert inference.build_parser().parse_args(
        ["--export_dir", "e", "--input", "i", "--output", "o"]).device \
        is None
    srv = pipeline.TFModel({}).setExportDir(export_dir).as_service(
        num_replicas=1)
    assert srv.spec.device is None and srv.spec.export_dir == export_dir
    ctx = argparse.Namespace(task_index=0, num_workers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mnist_inference.infer_fun(
            {"export_dir": export_dir, "data_dir": str(tmp_path),
             "output": str(tmp_path / "out")}, ctx)


def test_transform_rows_are_dicts_in_input_order(engine, tmp_path):
    """``transform`` keeps the input's order and gives one dict a row
    with the ``output_mapping`` columns."""
    export_dir = _linear_export(str(tmp_path / "export"), (1.0, 0.0))
    rows = [{"x": [float(i), 0.0]} for i in range(23)]
    out = (pipeline.TFModel({"device": "cpu"}).setExportDir(export_dir)
           .setInputMapping({"x": "x"}).setOutputMapping(
               {"prediction": "y"}).setBatchSize(5)
           .transform(engine.parallelize(rows, 3)).collect())
    assert out == [{"y": float(i)} for i in range(23)]
    assert json.loads(json.dumps(out)) == out
    assert os.path.isdir(export_dir)
