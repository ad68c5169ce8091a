"""PyTorch port, remote paths (``recordio/fs.py``'s fsspec routes, the
in-memory TFRecord framer and reader of ``native/tfrecord.cpp``,
``load_columnar``, ``dfutil`` and ``utils/checkpoint.py``), on the CPU,
against the JAX package, through ``memory://``, which both packages
share inside one process:

- a TFRecord written on ``memory://`` by either package is read by the
  other, and its bytes equal the same records written to a local file,
  through the native codec and through the Python one;
- ``load_columnar`` reads a ``memory://`` shard as it reads the local
  one;
- ``dfutil`` saves and loads a ``memory://`` directory;
- a checkpoint and an export written on ``memory://`` by either package
  are restored and loaded by the other, and pruning keeps ``keep``.
"""

import os
import uuid

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu import dfutil as JD  # noqa: E402
from tensorflowonspark_tpu import recordio as JR  # noqa: E402
from tensorflowonspark_tpu.recordio import native as JN  # noqa: E402
from tensorflowonspark_tpu.utils import checkpoint as JC  # noqa: E402
from tensorflowonspark_tpu_torch import dfutil, recordio  # noqa: E402
from tensorflowonspark_tpu_torch.recordio import fs  # noqa: E402
from tensorflowonspark_tpu_torch.recordio import (  # noqa: E402
    tfrecord_native,
)
from tensorflowonspark_tpu_torch.utils import checkpoint as C  # noqa: E402


@pytest.fixture
def url():
    """A fresh ``memory://`` directory, removed afterwards."""
    base = f"memory://tfos-test-{uuid.uuid4().hex[:8]}"
    yield base
    mfs, p = fs.get_fs(base)
    if mfs.exists(p):
        mfs.rm(p, recursive=True)


@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch):
    """Both packages on their native codecs, or both on the Python
    ones."""
    if request.param == "python":
        monkeypatch.setattr(tfrecord_native, "load", lambda: None)
        monkeypatch.setattr(JN, "load", lambda: None)
    assert recordio.codec() == request.param
    return request.param


def _examples(n=7):
    rng = np.random.default_rng(0)
    return [recordio.encode_example({
        "x": ("float", rng.random(3).astype(np.float32).tolist()),
        "y": ("int64", [i]),
        "b": ("bytes", [bytes(rng.integers(0, 256, i, np.uint8))])})
        for i in range(n)]


def test_scheme_routing_equals_jax():
    from tensorflowonspark_tpu.recordio import fs as JF

    for p in ("/a/b", "rel/x", "file:///a/b", "local:///c", "memory://d/e",
              "gs://bucket/k", "hdfs://nn:8020/x", "s3://b/k"):
        assert fs.is_local(p) == JF.is_local(p), p
        assert fs.local_path(p) == JF.local_path(p), p
        assert fs.scheme_of(p) == JF.scheme_of(p), p
    assert fs.join("memory://a/", "/b/", "c") == JF.join("memory://a/",
                                                         "/b/", "c")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tfrecords_cross_between_packages_on_memory(writer, codec, url,
                                                    tmp_path):
    recs = _examples() + [b""]
    W = recordio.TFRecordWriter if writer == "port" else JR.TFRecordWriter
    with W(fs.join(url, "part-r-00000")) as w:
        for r in recs:
            w.write(r)
    with recordio.TFRecordWriter(str(tmp_path / "local")) as w:
        for r in recs:
            w.write(r)
    remote = fs.read_bytes(fs.join(url, "part-r-00000"))
    assert remote == (tmp_path / "local").read_bytes()
    for R in (recordio.TFRecordReader, JR.TFRecordReader):
        assert list(R(fs.join(url, "part-r-00000"))) == recs
    assert fs.listdir(url) == ["part-r-00000"]
    assert fs.exists(fs.join(url, "part-r-00000"))
    # cut inside the last record's data crc: the port's readers raise
    # IOError, as the JAX native one does (the JAX Python codec raises
    # struct.error there: ROADMAP.md queue 3)
    fs.write_bytes(fs.join(url, "cut"), remote[:-2])
    readers = [recordio.TFRecordReader]
    if codec == "native":
        readers.append(JR.TFRecordReader)
    for R in readers:
        with pytest.raises(IOError):
            list(R(fs.join(url, "cut")))


def test_load_columnar_from_memory_equals_local(codec, url, tmp_path):
    recs = _examples()
    for path in (fs.join(url, "s"), str(tmp_path / "s")):
        with recordio.TFRecordWriter(path) as w:
            for r in recs:
                w.write(r)
    got = recordio.load_columnar(fs.join(url, "s"))
    want = recordio.load_columnar(str(tmp_path / "s"))
    jax_got = JR.load_columnar(fs.join(url, "s"))
    assert sorted(got) == sorted(want) == sorted(jax_got) == ["b", "x", "y"]
    for name in got:
        assert got[name][0] == want[name][0]
        for a, b in ((got, want), (got, jax_got)):
            if got[name][0] == "bytes":
                assert a[name][1] == b[name][1]
            else:
                np.testing.assert_array_equal(a[name][1], b[name][1])
    fs.write_bytes(fs.join(url, "bad"), fs.read_bytes(fs.join(url, "s"))[:-3])
    with pytest.raises(IOError):
        recordio.load_columnar(fs.join(url, "bad"))


def test_dfutil_on_a_memory_directory(url):
    rows = [{"id": i, "v": [0.5 * i, 1.0], "s": f"r{i}", "raw": bytes([i])}
            for i in range(9)]
    assert dfutil.save_as_tfrecords(rows, url) == url
    assert dfutil.part_files(url) == [fs.join(url, "part-r-00000")]
    got, schema = dfutil.load_tfrecords(None, url, binary_features=["raw"])
    assert got == rows
    want, jschema = JD.load_tfrecords(None, url, binary_features=["raw"])
    assert got == want and schema == jschema
    cols = dfutil.load_tfrecords_columnar(url)
    np.testing.assert_array_equal(cols["id"], np.arange(9))


def _tree(s):
    rng = np.random.default_rng(s)
    return {"params": {"conv": {"w": rng.random((3, 3, 2, 4), np.float32)},
                       "b": np.full(4, float(s), np.float32)},
            "opt": {"00000": rng.random(5, np.float32)}}


def _same(a, b):
    fa, fb = C._flatten(a), C._flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_and_exports_cross_on_memory(writer, url):
    ckpt_dir, export_dir = fs.join(url, "ckpt"), fs.join(url, "export")
    save = C.save_checkpoint if writer == "port" else JC.save_checkpoint
    export = C.export_model if writer == "port" else JC.export_model
    for s in range(1, 5):
        save(ckpt_dir, _tree(s), s, keep=2)
    assert sorted(fs.listdir(ckpt_dir)) == ["ckpt-00000003.npz",
                                            "ckpt-00000004.npz"]
    for mod in (C, JC):
        tree, step = mod.restore_latest(ckpt_dir)
        assert step == 4
        _same(tree, _tree(4))
        assert mod.latest(ckpt_dir) == (4, fs.join(ckpt_dir,
                                                   "ckpt-00000004.npz"))
        _same(mod.restore_step(ckpt_dir, 3), _tree(3))
        assert mod.restore_any(ckpt_dir)[1] == 4
    meta = {"predict": "tensorflowonspark_tpu_torch.models.mnist:predict"}
    assert export(export_dir, _tree(9), metadata=meta) == export_dir
    for mod in (C, JC):
        params, got_meta = mod.load_exported(export_dir)
        _same(params, _tree(9))
        assert got_meta == dict(meta, format="tfos-tpu-export-v1")
    # a torn newest step is skipped by the port's restores, as locally
    last = fs.join(ckpt_dir, "ckpt-00000004.npz")
    fs.write_bytes(last, fs.read_bytes(last)[:100])
    assert C.restore_latest(ckpt_dir)[1] == 3
    assert C.restore_any(ckpt_dir)[1] == 3


def test_remote_save_matches_the_local_file(url, tmp_path):
    """One PUT on a remote store, a tmp file and a rename locally: the
    same arrays either way, and no tmp file left behind."""
    C.save_checkpoint(url, _tree(1), 1)
    C.save_checkpoint(str(tmp_path), _tree(1), 1)
    _same(C.load_checkpoint(fs.join(url, "ckpt-00000001.npz")),
          C.load_checkpoint(str(tmp_path / "ckpt-00000001.npz")))
    assert os.listdir(tmp_path) == ["ckpt-00000001.npz"]
    assert fs.listdir(url) == ["ckpt-00000001.npz"]
