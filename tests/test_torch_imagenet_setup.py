"""PyTorch port, JPEG TFRecord shards on the ImageNet path, on the CPU:

- ``examples/imagenet_data_setup`` writes, from seeded JPEG shards
  (TF-official keys, 1-based labels, PNG and CMYK records among them,
  and invalid records that are skipped and counted), raw shards byte for
  byte equal to the JAX tool's (``examples/resnet/
  imagenet_data_setup.py``), in process and through a one-executor
  engine;
- the slice end to end: ``resnet_imagenet_spark`` with ``--data_dir`` on
  the JPEG shards (the executor reads and decodes them through the
  engine's lineage, every JPEG natively) gives the same losses as on
  their raw conversion (ResNet-50 at 32x32, batch 2, float32, 1e-6
  relative: the pixels are the same).

Every wait is bounded (``reservation_timeout``, ``feed_timeout``).
"""

import argparse
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu import recordio as JR  # noqa: E402
from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import recordio  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    imagenet_data_setup,
    resnet_imagenet_spark,
)
from tensorflowonspark_tpu_torch.recordio import jpeg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
SIZE = 32


@pytest.fixture(scope="module")
def engine1():
    e = LocalEngine(1, env={"OMP_NUM_THREADS": "2"})
    yield e
    e.stop()


def _img(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                     np.full((h, w), 128)], -1)
    return np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _encode(arr, fmt="JPEG", mode=None):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(
        buf, fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _jpeg_shards(d, shards, per, seed=0, odd=False):
    """``shards`` JPEG shards of ``per`` records under ``d`` with the
    TF-official keys; ``odd`` adds a PNG, a CMYK JPEG, a corrupt JPEG
    and a record without a label to the first shard."""
    rng = np.random.default_rng(seed)
    d.mkdir()
    labels = []
    for s in range(shards):
        with JR.TFRecordWriter(str(d / f"part-r-{s:05d}")) as w:
            payloads = [_encode(_img(rng, int(rng.integers(24, 60)),
                                     int(rng.integers(24, 60))))
                        for _ in range(per)]
            extra = []
            if odd and s == 0:
                payloads += [_encode(_img(rng, 20, 30), fmt="PNG"),
                             _encode(np.full((40, 30, 4), 90, np.uint8),
                                     mode="CMYK"),
                             b"\xff\xd8broken"]
                extra = [recordio.encode_example(
                    {"image/encoded": ("bytes", [payloads[0]])})]
            for p in payloads:
                label = int(rng.integers(1, 11))
                labels.append(label - 1)
                w.write(recordio.encode_example({
                    "image/encoded": ("bytes", [p]),
                    "image/class/label": ("int64", [label])}))
            for e in extra:
                w.write(e)
    return labels


def _jax_tool(monkeypatch):
    """The JAX tool, loaded by path with ``examples/resnet`` on the path
    (it imports ``imagenet_records`` from there) for this test only."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        "jax_imagenet_data_setup",
        os.path.join(REPO, "examples", "resnet", "imagenet_data_setup.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_setup_output_equals_the_jax_tool(monkeypatch, engine1, tmp_path):
    _jpeg_shards(tmp_path / "jpeg", 2, 5, odd=True)
    tool = _jax_tool(monkeypatch)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    for name in ("part-r-00000", "part-r-00001"):
        src = str(tmp_path / "jpeg" / name)
        want = tool.convert_shard(src, str(tmp_path / "jax" / name), SIZE)
        got = imagenet_data_setup.convert_shard(
            src, str(tmp_path / "port" / name), SIZE)
        # shard 0: a PNG and a CMYK JPEG decode; the corrupt JPEG and the
        # unlabelled record are skipped and counted
        assert got == want == ((7, 2) if name.endswith("0") else (5, 0))
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    results = imagenet_data_setup.convert(
        engine1, str(tmp_path / "jpeg"), str(tmp_path / "engine"), SIZE, 2)
    assert results == [("part-r-00000", 7, 2), ("part-r-00001", 5, 0)]
    for name in ("part-r-00000", "part-r-00001"):
        assert (tmp_path / "engine" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


def _resnet_run(engine, ds, out):
    out.mkdir()
    c = TFCluster.run(
        engine, resnet_imagenet_spark.main_fun,
        {"batch_size": 2, "lr": 0.01, "image_size": SIZE, "num_classes": 10,
         "model_dir": str(out / "model"), "device": "cpu",
         "compute_dtype": "float32", "out_dir": str(out)},
        num_executors=1, input_mode=TFCluster.InputMode.SPARK,
        reservation_timeout=TIMEOUT)
    c.train(ds, feed_timeout=TIMEOUT)
    assert c.server.fed_partitions("input") == list(range(ds.num_partitions))
    c.shutdown()
    return json.load(open(out / "resnet_imagenet-rank0.json"))


def test_jpeg_shards_train_as_their_raw_conversion(engine1, tmp_path):
    assert jpeg.available(), jpeg.error()
    labels = _jpeg_shards(tmp_path / "jpeg", 2, 4, seed=1)
    assert imagenet_data_setup.convert(
        engine1, str(tmp_path / "jpeg"), str(tmp_path / "raw"), SIZE, 2) == \
        [("part-r-00000", 4, 0), ("part-r-00001", 4, 0)]
    runs = {}
    for name in ("jpeg", "raw"):
        args = argparse.Namespace(data_dir=str(tmp_path / name),
                                  cluster_size=1, image_size=SIZE,
                                  batch_size=2, steps=4, num_classes=10,
                                  decode_threads=2)
        runs[name] = _resnet_run(
            engine1, resnet_imagenet_spark._records(args, engine1),
            tmp_path / f"run_{name}")
    assert len(runs["jpeg"]["losses"]) == len(labels) // 2 == 4
    np.testing.assert_allclose(runs["jpeg"]["losses"],
                               runs["raw"]["losses"], rtol=1e-6)
    # the executor decoded every JPEG natively; the raw run decoded none
    assert [f["jpeg"] for f in runs["jpeg"]["feeders"]] == \
        [{"native": 4, "pil": 0}] * 2
    assert [f["jpeg"] for f in runs["raw"]["feeders"]] == \
        [{"native": 0, "pil": 0}] * 2
