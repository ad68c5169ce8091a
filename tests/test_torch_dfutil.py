"""PyTorch port, ``dfutil``, the engine's ``map_partitions`` lineage and
``collect``, ``TFNodeContext.absolute_path`` and the export, against the
JAX package's on the same seeded inputs:

- ``to_example``, ``from_example`` and ``infer_schema`` equal, over the
  dtype matrix;
- ``save_as_tfrecords`` through the engine's ``collect`` (one shard a
  partition, written in the executors), which the JAX package reads
  back; ``load_tfrecords`` through the port's ``LocalEngine``, with
  ``min_partitions`` striping that reads every record once, and without
  an engine;
- ``load_tfrecords_columnar`` and ``iter_tfrecords_columnar`` batches
  equal to the JAX package's; drift raises, empty shards are skipped;
- ``map_partitions`` runs in the executor (another pid), stage by
  stage, and the task the engine pickles stays small; the last stage
  reaches the job as a generator;
- ``absolute_path`` equal to the JAX package's ``hdfs_path`` for
  ``file://``, absolute and relative paths;
- an export from either package loads in the other.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu import dfutil as JD  # noqa: E402
from tensorflowonspark_tpu import feed as JF  # noqa: E402
from tensorflowonspark_tpu.utils import checkpoint as JC  # noqa: E402
from tensorflowonspark_tpu_torch import dfutil as D  # noqa: E402
from tensorflowonspark_tpu_torch import node, recordio  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.utils import checkpoint as C  # noqa: E402

ROW = {
    "an_int": 7,
    "a_bool": True,
    "a_float": 3.25,
    "a_string": "hello gpu",
    "a_binary": b"\x00\xffraw",
    "int_array": [1, -2, 3],
    "float_array": [0.5, 1.5, -2.5],
    "str_array": ["a", "b"],
    "neg_int": -42,
    "np_int": np.int32(5),
    "np_float": np.float32(0.75),
    "np_array": np.arange(4, dtype=np.uint8),
}
BINARY = ("a_binary",)


@pytest.fixture(scope="module")
def engine():
    e = LocalEngine(2, env={"OMP_NUM_THREADS": "2"})
    yield e
    e.stop()


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(ROW, an_int=i, a_float=float(np.float32(rng.random())),
                 a_binary=rng.bytes(5)) for i in range(n)]


def test_row_example_codec_equals_jax():
    ex = D.to_example(ROW)
    assert ex == JD.to_example(ROW)
    for hint in ((), BINARY):
        assert D.infer_schema(ex, hint) == JD.infer_schema(ex, hint)
    assert D.from_example(ex, binary_features=BINARY) == \
        JD.from_example(ex, binary_features=BINARY)
    # bytes that are not UTF-8 and not hinted binary fail alike
    with pytest.raises(UnicodeDecodeError):
        D.from_example(ex)
    with pytest.raises(UnicodeDecodeError):
        JD.from_example(ex)
    with pytest.raises(TypeError):
        D.to_example({"x": object()})


def test_save_and_load_through_the_engine(engine, tmp_path):
    """The port writes shards in its executors (``collect`` of
    ``write_partition``); the JAX package reads them back; the port
    reads them through read units in its executors, every record once:
    in file order, or striped to reach ``min_partitions``."""
    rows = _rows(30)
    out = str(tmp_path / "tfr")
    D.save_as_tfrecords(engine.parallelize(rows, 3), out)
    files = D.part_files(out)
    assert len(files) == 3 and files == JD.part_files(out)
    jrows, jschema = JD.load_tfrecords(None, out, BINARY)
    assert sorted(jrows, key=lambda r: r["an_int"]) == \
        [D.from_example(D.to_example(r), jschema, BINARY) for r in rows]

    for min_parts, want_parts in ((None, 3), (7, 7)):
        ds, schema = D.load_tfrecords(engine, out, BINARY,
                                      min_partitions=min_parts)
        assert schema == jschema and D.is_loaded_df(out)
        assert ds.num_partitions == want_parts
        got = ds.collect()
        assert sorted(r["an_int"] for r in got) == list(range(30))
        if min_parts is None:
            assert got == [r for f in files
                           for r in D.read_shard(schema, BINARY)([f])]
        # each read unit crossed the pipe, not its records
        assert engine.last_dispatch["max_bytes"] < 4096
    local, schema = D.load_tfrecords(None, out, BINARY)
    assert local == JD.load_tfrecords(None, out, BINARY)[0]

    one = str(tmp_path / "one")
    D.save_as_tfrecords(rows[:4], one)  # a plain list: one shard
    assert D.part_files(one) == [os.path.join(one, "part-r-00000")]


class _Tag:
    """A ``map_partitions`` stage: each item with this process's pid."""

    def __call__(self, it):
        return [(x, os.getpid()) for x in it]


class _Double:
    def __call__(self, it):
        for x, pid in it:
            yield 2 * x, pid


def test_map_partitions_runs_in_the_executor(engine):
    ds = engine.parallelize(range(10), 3).map_partitions(_Tag())
    ds = ds.map_partitions(_Double())
    assert ds.num_partitions == 3
    got = ds.collect()
    assert [x for x, _ in got] == [2 * i for i in range(10)]
    assert os.getpid() not in {pid for _, pid in got}
    assert engine.last_dispatch["max_bytes"] < 1024
    # a union keeps each branch's chain; repartition goes through the
    # driver
    both = ds.union(engine.parallelize([100], 1))
    assert both.num_partitions == 4
    assert [x if isinstance(x, int) else x[0] for x in both.collect()] \
        == [2 * i for i in range(10)] + [100]
    assert sorted(x for x, _ in ds.repartition(2).collect()) == \
        [2 * i for i in range(10)]
    assert ds.repartition(2).num_partitions == 2


class _Observe:
    """A job's function: writes what it was handed, and the stage times
    the executor recorded before and after it consumed the items."""

    def __init__(self, out_dir):
        self.out_dir = out_dir

    def __call__(self, it):
        import inspect
        import json

        from tensorflowonspark_tpu_torch import engine

        before = list(engine.task_report["lineage_ms"])
        items = [x for x, _ in it]
        with open(os.path.join(self.out_dir, f"{items[0]}.json"), "w") as f:
            json.dump({"generator": inspect.isgenerator(it), "items": items,
                       "before": before,
                       "after": engine.task_report["lineage_ms"]}, f)


def test_lineage_keeps_the_last_stage_lazy(engine, tmp_path):
    """Every stage but the last is materialised; the job gets the last
    one's generator, as the JAX package's composed chain hands it, and
    the last stage's time grows as the job consumes it."""
    import json

    from tensorflowonspark_tpu_torch.engine import Lineage

    produced = []

    def last(it):
        for x, pid in it:
            produced.append(x)
            yield x

    ms = []
    out = Lineage((_Tag(), last)).run(range(3), ms)
    assert produced == [] and len(ms) == 2
    assert next(out) == 0 and produced == [0]
    assert list(out) == [1, 2] and produced == [0, 1, 2]

    ds = engine.parallelize(range(6), 2).map_partitions(_Tag())
    ds.map_partitions(_Double()).foreach_partition(_Observe(str(tmp_path)))
    seen = [json.load(open(tmp_path / f"{first}.json")) for first in (0, 6)]
    assert [s["items"] for s in seen] == [[0, 2, 4], [6, 8, 10]]
    for s in seen:
        assert s["generator"] and len(s["before"]) == len(s["after"]) == 2
        assert s["before"][0] == s["after"][0]
        assert s["after"][1] >= s["before"][1]


def _write(path, examples):
    with recordio.TFRecordWriter(str(path)) as w:
        for feats in examples:
            w.write(recordio.encode_example(feats))


def test_columnar_loaders_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    d = tmp_path / "tfr"
    d.mkdir()
    vals = rng.random((23, 3)).astype(np.float32)
    _write(d / "part-r-00000", [{"x": ("int64", [i]),
                                 "v": ("float", vals[i].tolist()),
                                 "s": ("bytes", [bytes([i])])}
                                for i in range(9)])
    (d / "part-r-00001").write_bytes(b"")  # an empty part
    _write(d / "part-r-00002", [{"x": ("int64", [i]),
                                 "v": ("float", vals[i].tolist()),
                                 "s": ("bytes", [bytes([i])])}
                                for i in range(9, 23)])
    got, want = D.load_tfrecords_columnar(str(d)), \
        JD.load_tfrecords_columnar(str(d))
    assert sorted(got) == sorted(want) == ["s", "v", "x"]
    np.testing.assert_array_equal(got["x"], np.arange(23))
    np.testing.assert_array_equal(got["v"], want["v"])
    assert got["s"] == want["s"]
    files = [str(d / "part-r-00000"), str(d / "part-r-00001")]
    np.testing.assert_array_equal(D.load_tfrecords_columnar(files)["x"],
                                  np.arange(9))
    for size, drop in ((4, False), (5, True), (30, False)):
        got = list(D.iter_tfrecords_columnar(str(d), size,
                                             drop_remainder=drop))
        want = list(JD.iter_tfrecords_columnar(str(d), size,
                                               drop_remainder=drop))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["x"], w["x"])
            np.testing.assert_array_equal(g["v"], w["v"])
            assert g["s"] == w["s"]
    with pytest.raises(ValueError, match="batch_size"):
        next(D.iter_tfrecords_columnar(str(d), 0))

    e = tmp_path / "empty"
    e.mkdir()
    (e / "part-r-00000").write_bytes(b"")
    assert D.load_tfrecords_columnar(str(e)) == {}
    with pytest.raises(FileNotFoundError):
        D.part_files(str(tmp_path / "tfr" / ".."))  # no part-* files here
    for second in ({"y": ("int64", [2])}, {"x": ("float", [2.0])},
                   {"x": ("int64", [1, 2])}):
        bad = tmp_path / f"drift{len(list(tmp_path.iterdir()))}"
        bad.mkdir()
        _write(bad / "part-r-00000", [{"x": ("int64", [1])}])
        _write(bad / "part-r-00001", [second])
        with pytest.raises(ValueError, match="schema"):
            D.load_tfrecords_columnar(str(bad))
        with pytest.raises(ValueError, match="schema"):
            list(D.iter_tfrecords_columnar(str(bad), 1))


class _Ctx:
    def __init__(self, default_fs, working_dir):
        self.default_fs = default_fs
        self.working_dir = working_dir
        self.cluster_spec = {"chief": [{}], "worker": [{}, {}], "ps": [{}]}


@pytest.mark.parametrize("default_fs", ["file://", "hdfs://nn:8020",
                                        "gs://bucket", "weird://x"])
def test_absolute_path_equals_jax(default_fs):
    ctx = _Ctx(default_fs, "/work/dir")
    port = node.TFNodeContext(0, "worker", 0, ctx.cluster_spec, default_fs,
                              "/work/dir", None)
    assert port.num_workers == 3
    for path in ("file:///a/b", "/abs/data", "rel/data", "hdfs://h/x",
                 "gs://b/y"):
        assert port.absolute_path(path) == JF.hdfs_path(ctx, path), path
    if default_fs == "file://":
        assert recordio.fs.local_path(port.absolute_path("rel")) == \
            "/work/dir/rel"
        # a remote URL is left to fsspec, as in the JAX package
        assert recordio.fs.local_path("gs://b/y") == "gs://b/y"
        assert not recordio.fs.is_local("gs://b/y")


def test_exports_load_in_either_package(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"conv1": {"w": rng.random((3, 3, 1, 4)).astype(np.float32),
                      "b": np.zeros(4, np.float32)},
            "fc": {"w": rng.random((8, 2)).astype(np.float32)}}
    meta = {"predict": "tensorflowonspark_tpu_torch.models.mnist:predict"}
    port_dir = str(tmp_path / "port")
    assert C.export_model(port_dir, {k: {n: torch.from_numpy(v)
                                         for n, v in p.items()}
                                     for k, p in tree.items()},
                          metadata=meta) == port_dir
    jax_dir = str(tmp_path / "jax")
    JC.export_model(jax_dir, tree, metadata=meta)
    for params, got_meta in (JC.load_exported(port_dir),
                             C.load_exported(jax_dir),
                             C.load_exported("file://" + port_dir)):
        assert got_meta == dict(meta, format="tfos-tpu-export-v1")
        for k, p in tree.items():
            for n, v in p.items():
                np.testing.assert_array_equal(params[k][n], v)
    assert C.load_export_meta(jax_dir) == JC.load_export_meta(port_dir)
    assert sorted(os.listdir(port_dir)) == ["export.json", "params.npz"]

    class _Worker:
        job_name, task_index = "worker", 1
        cluster_spec = {"worker": [0, 1]}

    assert C.export_model(str(tmp_path / "no"), tree, _Worker()) is None
    assert not os.path.exists(tmp_path / "no")
