"""PyTorch port, batch inference on the CPU: the schema parser against
the JAX package's, the inference CLI against the JAX CLI on the same
records and export, a JAX-made MNIST export through the port's CLI and
through ``parallel_run`` (``examples/mnist_inference``), and
``TFCluster.inference()`` with ``examples/mnist_pipeline.infer_fun``
giving JAX's logits for every row once, in order.

The ``main_fun``s are module-level functions of this file or of the
port's examples, which the executors import, so this file imports no
JAX at the top.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu.utils import schema as jax_schema  # noqa: E402
from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import inference  # noqa: E402
from tensorflowonspark_tpu_torch import parallel_run  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.utils import schema  # noqa: E402

TIMEOUT = 60
# MNIST logits: the port against JAX's predict, relative to the largest
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def engine():
    e = LocalEngine(2, env={"OMP_NUM_THREADS": "2"})
    yield e
    e.stop()


# -- the schema parser, case by case against the JAX package's ----------------

@pytest.mark.parametrize("text", [
    "struct<a:bigint,b:float,c:string,d:binary,e:array<float>,"
    "f:array<bigint>>",
    "x:boolean,y:int,z:double",
    "struct<img:array<binary>,label:tinyint>",
    "struct<>",
])
def test_parse_and_format_round_trip_as_jax(text):
    parsed = schema.parse_schema(text)
    assert parsed == jax_schema.parse_schema(text)
    assert schema.format_schema(parsed) == jax_schema.format_schema(parsed)
    assert schema.parse_schema(schema.format_schema(parsed)) == parsed


@pytest.mark.parametrize("bad", ["struct<a:", "a:unknown", "a;int",
                                 "x:array<>"])
def test_parse_errors_as_jax(bad):
    with pytest.raises(jax_schema.SchemaParseError):
        jax_schema.parse_schema(bad)
    with pytest.raises(schema.SchemaParseError):
        schema.parse_schema(bad)


def test_merge_partial_hint_as_jax():
    inferred = {"img": ("string", True), "label": ("int64", False)}
    hint = schema.parse_schema("img:array<binary>")
    assert schema.merge_schemas(inferred, hint) == \
        jax_schema.merge_schemas(inferred, hint) == \
        {"img": ("bytes", True), "label": ("int64", False)}


# -- the CLI against the JAX CLI ----------------------------------------------

def _read_json_dir(out_dir):
    rows = []
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            rows.extend(json.loads(line) for line in f)
    return rows


def _cli_args(mod, export_dir, data_dir, out_dir, *extra):
    return mod.build_parser().parse_args([
        "--export_dir", export_dir, "--input", data_dir, "--output", out_dir,
        "--schema_hint", "struct<features:array<float>,label:float>",
        "--input_mapping", json.dumps({"features": "x"}),
        "--output_mapping", json.dumps({"prediction": "preds"}),
        "--batch_size", "4", *extra])


def test_inference_cli_gives_the_jax_cli_json(engine, tmp_path):
    """The JAX CLI's own end-to-end case (20 records, a linear export
    from the JAX package): both CLIs write the same predictions."""
    import jax.numpy as jnp

    from tensorflowonspark_tpu import dfutil as jax_dfutil
    from tensorflowonspark_tpu import inference as jax_inference
    from tensorflowonspark_tpu.engine import LocalEngine as JaxEngine
    from tensorflowonspark_tpu.utils import checkpoint as jax_ckpt

    rows = [{"features": [float(i), float(2 * i)],
             "label": float(2 * i + 6 * i)} for i in range(20)]
    data_dir = str(tmp_path / "data")
    jax_dfutil.save_as_tfrecords(rows, data_dir)
    export_dir = str(tmp_path / "export")
    jax_ckpt.export_model(
        export_dir, {"w": jnp.asarray([2.0, 3.0]), "b": jnp.asarray(0.0)},
        metadata={"predict": "tensorflowonspark_tpu.models.linear:predict"})

    jax_out = str(tmp_path / "jax_preds")
    jax_engine = JaxEngine(num_executors=2)
    try:
        jax_inference.run(_cli_args(jax_inference, export_dir, data_dir,
                                    jax_out), source=jax_engine)
    finally:
        jax_engine.stop()
    port_out = str(tmp_path / "port_preds")
    shards = inference.run(_cli_args(inference, export_dir, data_dir,
                                     port_out, "--device", "cpu"),
                           source=engine)
    assert shards and all(os.path.exists(s) for s in shards)
    want = sorted(r["preds"] for r in _read_json_dir(jax_out))
    got = sorted(r["preds"] for r in _read_json_dir(port_out))
    assert len(got) == 20
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, sorted(8.0 * i for i in range(20)),
                               atol=1e-5)


# -- a JAX-made MNIST export: the CLI and parallel_run ------------------------

@pytest.fixture(scope="module")
def mnist_case(tmp_path_factory):
    """Four TFRecord shards of seeded MNIST-shaped records, a JAX-made
    export, and JAX's predictions on every record."""
    import jax

    from tensorflowonspark_tpu.models import mnist as jax_mnist
    from tensorflowonspark_tpu.utils import checkpoint as jax_ckpt
    from tensorflowonspark_tpu_torch.examples import mnist_data_setup

    root = tmp_path_factory.mktemp("mnist")
    images, labels = mnist_data_setup.synthetic_mnist(96, seed=4)
    _, tfr = mnist_data_setup.write_shards(images, labels, str(root), 4)
    export_dir = str(root / "export")
    params = jax_mnist.init_params(jax.random.PRNGKey(7))
    jax_ckpt.export_model(export_dir, params, metadata={
        "predict": "tensorflowonspark_tpu.models.mnist:predict"})
    want = jax_mnist.predict(params, {"x": images.reshape(-1, 784)})
    return {"tfr": tfr, "export": export_dir, "images": images,
            "labels": labels, "want": want, "root": root}


def test_inference_cli_mnist_export_gives_jax_logits(engine, mnist_case):
    out_dir = str(mnist_case["root"] / "cli_preds")
    args = inference.build_parser().parse_args([
        "--export_dir", mnist_case["export"], "--input", mnist_case["tfr"],
        "--output", out_dir, "--input_mapping", json.dumps({"image": "x"}),
        "--output_mapping", json.dumps({"logits": "logits",
                                        "prediction": "pred"}),
        "--batch_size", "16", "--device", "cpu"])
    shards = inference.run(args, source=engine)
    # one shard a partition, one partition a part file, rows in file
    # order: each shard is held against the file block it matches
    want = mnist_case["want"]
    blocks = [slice(i * 24, (i + 1) * 24) for i in range(4)]
    matched = []
    for path in shards:
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        got = np.asarray([r["logits"] for r in rows], np.float32)
        errs = [np.abs(got - want["logits"][b]).max()
                / np.abs(want["logits"]).max() for b in blocks]
        best = int(np.argmin(errs))
        matched.append(best)
        assert errs[best] <= LOGIT_RTOL, errs
        assert [r["pred"] for r in rows] == \
            want["prediction"][blocks[best]].tolist()
    assert sorted(matched) == [0, 1, 2, 3]


def test_parallel_run_mnist_inference_example(mnist_case):
    """``examples/mnist_inference`` over ``parallel_run``: two workers
    split the four shards; every record's line is its label and JAX's
    prediction."""
    from tensorflowonspark_tpu_torch.examples import mnist_inference

    out_dir = str(mnist_case["root"] / "parallel_preds")
    eng = LocalEngine(2, env={"OMP_NUM_THREADS": "2"})
    try:
        counts = parallel_run.run(
            eng, mnist_inference.infer_fun,
            {"data_dir": mnist_case["tfr"],
             "export_dir": mnist_case["export"], "output": out_dir,
             "device": "cpu"}, num_executors=2)
    finally:
        eng.stop()
    assert sum(counts) == len(mnist_case["labels"])
    lines = []
    for name in sorted(os.listdir(out_dir)):
        lines += open(os.path.join(out_dir, name)).read().split("\n")[:-1]
    # worker 0 reads shards 0 and 2, worker 1 shards 1 and 3 (24 each)
    per = [list(range(s * 24, (s + 1) * 24)) for s in range(4)]
    order = per[0] + per[2] + per[1] + per[3]
    want = [f"{mnist_case['labels'][i]} "
            f"{mnist_case['want']['prediction'][i]}" for i in order]
    assert lines == want


def ctx_probe(args, ctx):
    return {"worker": ctx.task_index, "num_workers": ctx.num_workers,
            "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "args": args}


def test_parallel_run_claims_a_gpu_block_per_worker():
    from tensorflowonspark_tpu_torch import gpu_info

    eng = LocalEngine(2, env={"OMP_NUM_THREADS": "1",
                              gpu_info.COUNT_ENV: "4",
                              "CUDA_VISIBLE_DEVICES": None,
                              gpu_info.INHERITED_ENV: None})
    try:
        out = parallel_run.run(eng, ctx_probe, {"k": 1}, num_gpus=2)
        with pytest.raises(ValueError, match="requires 3 executors"):
            parallel_run.run(eng, ctx_probe, {}, num_executors=3)
    finally:
        eng.stop()
    assert out == [{"worker": 0, "num_workers": 2, "cuda_visible": "0,1",
                    "args": {"k": 1}},
                   {"worker": 1, "num_workers": 2, "cuda_visible": "2,3",
                    "args": {"k": 1}}]


# -- TFCluster.inference() with the MNIST trainer -----------------------------

def test_cluster_inference_mnist_rows_once_in_order(mnist_case, tmp_path):
    """``mnist_pipeline.infer_fun`` as the SPARK-mode trainer: each
    (id, image) row's result comes back once, in partition order, with
    JAX's logits."""
    from tensorflowonspark_tpu_torch.examples import mnist_pipeline

    images = mnist_case["images"].reshape(-1, 784)
    rows = [(i, images[i]) for i in range(len(images))]
    eng = LocalEngine(2, env={"OMP_NUM_THREADS": "2",
                              "TFOS_FEED_CHUNK": "10"})
    try:
        cluster = TFCluster.run(
            eng, mnist_pipeline.infer_fun,
            {"export_dir": mnist_case["export"], "batch_size": 16,
             "device": "cpu", "out_dir": str(tmp_path)},
            num_executors=2, input_mode=TFCluster.InputMode.SPARK,
            reservation_timeout=TIMEOUT)
        out = cluster.inference(eng.parallelize(rows, 6),
                                feed_timeout=TIMEOUT).collect()
        cluster.shutdown()
    finally:
        eng.stop()
    assert [r[0] for r in out] == list(range(len(images)))
    want = mnist_case["want"]
    got = np.asarray([r[2] for r in out], np.float32)
    err = np.abs(got - want["logits"]).max() / np.abs(want["logits"]).max()
    assert err <= LOGIT_RTOL, err
    assert [r[1] for r in out] == want["prediction"].tolist()
    reports = [json.load(open(tmp_path / f"infer-rank{r}.json"))
               for r in range(2)]
    assert sum(r["records"] for r in reports) == len(images)
    assert all(r["device"] == "cpu" for r in reports)
