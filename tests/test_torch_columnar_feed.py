"""PyTorch port, the columnar feed on the CPU: the feeder's chunk encoder
(``node._make_chunk_encoder``) and ``DataFeed``'s ColumnChunk paths give
what the row path gives.  The port's copy of tests/test_columnar_feed.py
against the port's manager and ``DataFeed``, the bare-array records of
the transformer feed, the zero-copy batch out of the shm ring, and a
SPARK-fed MNIST run through ``cluster.run`` on a one-executor
``LocalEngine``: over the ring it reports transport ``"shm"`` and
columnar chunks, consumes every partition once, gives the losses of the
same run over the manager queue (``TFOS_SHM_FEED=0``), and leaves no
segment in ``/dev/shm``.
"""

import json
import os
import secrets

import numpy as np
import pytest

pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import manager as tfmanager  # noqa: E402
from tensorflowonspark_tpu_torch import marker, node  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.examples import mnist_spark  # noqa: E402
from tensorflowonspark_tpu_torch.feed import DataFeed  # noqa: E402
from tensorflowonspark_tpu_torch.recordio import shm  # noqa: E402

ROWS = [([float(i), float(2 * i)], i % 7) for i in range(100)]
IMG_ROWS = [(np.full((4, 6, 3), i, np.uint8), i % 10) for i in range(64)]
TIMEOUT = 90


def test_encoder_numeric_rows_go_columnar():
    chunk = node._make_chunk_encoder()(list(ROWS))
    assert isinstance(chunk, marker.ColumnChunk)
    assert len(chunk) == len(ROWS)
    assert chunk.spec == [("d", 2), ("l", 0)]
    np.testing.assert_allclose(chunk.columns[0][3], [3.0, 6.0])
    assert chunk.columns[1][3] == 3


def test_encoder_string_rows_stay_rows():
    enc = node._make_chunk_encoder()
    rows = [("hello", 1), ("world", 2)]
    assert enc(rows) is rows
    # and the encoder stays off for later chunks
    assert not isinstance(enc(list(ROWS)), marker.ColumnChunk)


def test_encoder_ragged_rows_fall_back():
    rows = [([1.0], 1), ([1.0, 2.0], 2)]
    assert node._make_chunk_encoder()(rows) is rows


def test_encoder_disabled_by_env(monkeypatch):
    monkeypatch.setenv("TFOS_COLUMNAR_FEED", "0")
    enc = node._make_chunk_encoder()
    assert not isinstance(enc(list(ROWS)), marker.ColumnChunk)


def test_encoder_flattens_nd_image_fields():
    chunk = node._make_chunk_encoder()(list(IMG_ROWS[:32]))
    assert isinstance(chunk, marker.ColumnChunk)
    assert chunk.shapes == ((4, 6, 3), None)
    assert chunk.spec[0] == ("B", 4 * 6 * 3)
    assert chunk.columns[0].shape == (32, 72)
    np.testing.assert_array_equal(
        chunk.columns[0][5].reshape(4, 6, 3), IMG_ROWS[5][0])


def test_encoder_nd_shape_drift_falls_back_to_rows():
    enc = node._make_chunk_encoder()
    assert isinstance(enc(list(IMG_ROWS[:8])), marker.ColumnChunk)
    drift = [(np.zeros((6, 4, 3), np.uint8), 1)] * 4  # transposed shape
    assert enc(drift) is drift


def test_encoder_bare_array_records_and_their_drift():
    """A record that is a bare array (a token sequence) is one field,
    tagged BARE; a later record that is not an array turns the encoder
    off for the rest of the partition."""
    enc = node._make_chunk_encoder()
    toks = [np.arange(i, i + 6, dtype=np.int32) for i in range(5)]
    chunk = enc(toks)
    assert isinstance(chunk, marker.ColumnChunk)
    assert chunk.meta == marker.BARE and chunk.spec == [("i", 6)]
    assert chunk.columns[0].dtype == np.int32
    np.testing.assert_array_equal(chunk.columns[0], np.stack(toks))
    mixed = [toks[0], (1, 2)]
    assert enc(mixed) is mixed


@pytest.fixture
def mgr():
    m = tfmanager.start(secrets.token_bytes(8), ["input", "output", "error"])
    yield m
    m.shutdown()


def _feed_chunks(mgr, chunks):
    q = mgr.get_queue("input")
    for c in chunks:
        q.put(c)
    q.put(None)


def _drain_batches(feed, batch_size):
    out = []
    while not feed.should_stop():
        out.append(feed.next_batch(batch_size))
    return out


def test_datafeed_columnar_mapping_equals_row_path(mgr):
    enc = node._make_chunk_encoder()
    # batch size 16 deliberately misaligned with chunk size 24
    _feed_chunks(mgr, [enc(ROWS[i:i + 24]) for i in range(0, 100, 24)])
    feed = DataFeed(mgr, input_mapping={"x": "features", "y": "label"})
    xs, ys = [], []
    for b in _drain_batches(feed, 16):
        assert isinstance(b["features"], list)
        xs.extend(np.asarray(v) for v in b["features"])
        ys.extend(int(v) for v in b["label"])
    np.testing.assert_allclose(np.stack(xs), [r[0] for r in ROWS])
    assert ys == [r[1] for r in ROWS]
    assert feed.records == len(ROWS)
    assert feed.stats()["columnar"] and feed.transport == "manager"


def test_datafeed_columnar_no_mapping_roundtrip(mgr):
    enc = node._make_chunk_encoder()
    _feed_chunks(mgr, [enc(ROWS[:50]), enc(ROWS[50:])])
    feed = DataFeed(mgr)
    records = []
    while not feed.should_stop():
        records.extend(feed.next_batch(13))
    assert len(records) == len(ROWS)
    for got, want in zip(records, ROWS):
        np.testing.assert_allclose(got[0], want[0])
        assert got[1] == want[1]


def test_datafeed_nd_columnar_row_consumers_see_original_shape(mgr):
    enc = node._make_chunk_encoder()
    _feed_chunks(mgr, [enc(list(IMG_ROWS[:40])), enc(list(IMG_ROWS[40:]))])
    feed = DataFeed(mgr, input_mapping={"image": "image", "label": "label"})
    got_imgs, got_labels = [], []
    for b in _drain_batches(feed, 16):
        for v in b["image"]:
            assert v.shape == (4, 6, 3)
            got_imgs.append(v)
        got_labels.extend(int(v) for v in b["label"])
    np.testing.assert_array_equal(np.stack(got_imgs),
                                  np.stack([r[0] for r in IMG_ROWS]))
    assert got_labels == [r[1] for r in IMG_ROWS]


def test_datafeed_nd_columnar_no_mapping_roundtrip(mgr):
    _feed_chunks(mgr, [node._make_chunk_encoder()(list(IMG_ROWS))])
    feed = DataFeed(mgr)
    records = []
    while not feed.should_stop():
        records.extend(feed.next_batch(24))
    assert len(records) == len(IMG_ROWS)
    for got, want in zip(records, IMG_ROWS):
        assert got[0].shape == (4, 6, 3)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_datafeed_bare_records_come_back_as_arrays(mgr):
    """The transformer's records: bare int32 arrays in, the same arrays
    (own copies, same dtype) out of next_batch, across a chunk seam."""
    toks = [np.random.default_rng(i).integers(0, 99, 8).astype(np.int32)
            for i in range(10)]
    enc = node._make_chunk_encoder()
    _feed_chunks(mgr, [enc(toks[:6]), enc(toks[6:])])
    feed = DataFeed(mgr)
    b1, b2 = feed.next_batch(4), feed.next_batch(6)
    for got, want in zip(b1 + b2, toks):
        assert isinstance(got, np.ndarray) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert b1[0].base is None  # a copy: it does not pin the chunk


def test_next_batch_columns_dense_and_zero_copy(mgr):
    """Aligned chunk -> zero-copy dense batch; spanning chunks -> one
    concatenate; end of feed -> an empty batch of the same dtype."""
    enc = node._make_chunk_encoder()
    _feed_chunks(mgr, [enc(list(IMG_ROWS[:32])), enc(list(IMG_ROWS[32:56])),
                       enc(list(IMG_ROWS[56:]))])
    feed = DataFeed(mgr, input_mapping={"image": "image", "label": "label"})

    b1 = feed.next_batch_columns(32)  # exactly chunk 1: zero copy
    assert b1["image"].shape == (32, 4, 6, 3)
    assert b1["image"].dtype == np.uint8
    assert b1["image"].base is not None
    np.testing.assert_array_equal(
        b1["image"], np.stack([r[0] for r in IMG_ROWS[:32]]))

    b2 = feed.next_batch_columns(32)  # spans chunks 2+3: one concat
    assert b2["image"].shape == (32, 4, 6, 3)
    np.testing.assert_array_equal(
        b2["image"], np.stack([r[0] for r in IMG_ROWS[32:]]))
    assert list(b2["label"]) == [r[1] for r in IMG_ROWS[32:]]

    tail = feed.next_batch_columns(32)
    assert feed.should_stop() and len(tail["image"]) == 0
    assert tail["image"].dtype == np.uint8
    assert tail["image"].shape == (0, 4, 6, 3)


def test_next_batch_columns_row_chunk_fallback(mgr):
    _feed_chunks(mgr, [list(IMG_ROWS[:20]), list(IMG_ROWS[20:48])])
    feed = DataFeed(mgr, input_mapping={"image": "image", "label": "label"})
    b = feed.next_batch_columns(48)
    assert b["image"].shape == (48, 4, 6, 3)
    np.testing.assert_array_equal(
        b["image"], np.stack([r[0] for r in IMG_ROWS[:48]]))
    assert not feed.stats()["columnar"] and feed.row_chunks == 2


def test_next_batch_columns_requires_mapping(mgr):
    with pytest.raises(ValueError, match="input_mapping"):
        DataFeed(mgr).next_batch_columns(8)


def test_datafeed_mixed_row_and_columnar_chunks(mgr):
    enc = node._make_chunk_encoder()
    _feed_chunks(mgr, [ROWS[:30], enc(ROWS[30:60]), ROWS[60:]])
    feed = DataFeed(mgr, input_mapping={"x": "features", "y": "label"})
    total = 0
    for b in _drain_batches(feed, 10):
        n = len(b["label"])
        assert len(b["features"]) == n
        total += n
    assert total == len(ROWS)


def test_ring_batch_is_a_view_of_the_popped_buffer_and_survives_pops():
    """Over the ring: an aligned image chunk comes out of
    next_batch_columns as a view of the buffer its pop allocated, with
    the records' dtype; later pops never reuse that buffer."""
    name = f"/tfosq-torch-{os.getpid()}-cf"
    ring = shm.ShmQueue(name, capacity=1 << 20, create=True)

    class Mgr:
        def get(self, key):
            return name if key == "shm_input" else None

    try:
        prod = shm.ShmQueue(name, create=False, producer=True)
        enc = node._make_chunk_encoder()
        for lo in (0, 16, 32):
            prod.put(enc(list(IMG_ROWS[lo:lo + 16])))
        prod.put(None)
        prod.close()
        feed = DataFeed(Mgr(), input_mapping={"image": "image",
                                              "label": "label"})
        assert feed.transport == "shm"
        b1 = feed.next_batch_columns(16)
        assert b1["image"].dtype == np.uint8
        assert b1["label"].dtype == np.int64
        base = b1["image"]
        while isinstance(base, np.ndarray):
            base = base.base
        buf = base.obj  # the np.empty buffer that its pop allocated
        assert buf.dtype == np.uint8 and buf.ndim == 1
        assert np.shares_memory(b1["image"], buf)
        rest = feed.next_batch_columns(32)
        np.testing.assert_array_equal(
            b1["image"], np.stack([r[0] for r in IMG_ROWS[:16]]))
        np.testing.assert_array_equal(
            rest["image"], np.stack([r[0] for r in IMG_ROWS[16:48]]))
        assert feed.next_batch_columns(16)["image"].shape[0] == 0
        assert feed.should_stop()
        stats = feed.stats()
        assert len(stats["pops"]) == 4
        # every pop is timed, with no metrics or telemetry asked for
        assert stats["wait_s"] == feed.wait_s >= \
            sum(ms for _, ms, _ in stats["pops"]) / 1e3 > 0
    finally:
        ring.close()


# -- SPARK-fed, end to end ------------------------------------------------------

def _spark_mnist(out_dir, env):
    batch, steps, parts = 16, 6, 3
    records = mnist_spark.synthetic_records(batch * steps, seed=4)
    engine = LocalEngine(1, env={"OMP_NUM_THREADS": "2", **env})
    try:
        c = TFCluster.run(engine, mnist_spark.main_fun,
                          {"batch_size": batch, "lr": 0.05, "device": "cpu",
                           "seed": 0, "out_dir": str(out_dir)},
                          num_executors=1,
                          input_mode=TFCluster.InputMode.SPARK,
                          reservation_timeout=TIMEOUT)
        ring = "/dev/shm" + node.feed_ring_name(c.cluster_meta["id"], 0)
        during = os.path.exists(ring)
        c.train(engine.parallelize(records, parts), feed_timeout=TIMEOUT)
        fed = c.server.fed_partitions("input")
        c.shutdown()
        after = os.path.exists(ring)
    finally:
        engine.stop()
    report = json.load(open(os.path.join(out_dir, "mnist-rank0.json")))
    return report, fed, during, after


def test_spark_fed_mnist_over_the_ring_equals_the_manager_queue(tmp_path):
    shm_dir, mgr_dir = tmp_path / "shm", tmp_path / "mgr"
    shm_dir.mkdir()
    mgr_dir.mkdir()
    ring_run, fed, during, after = _spark_mnist(shm_dir, {})
    assert during and not after  # made at node start, unlinked at shutdown
    assert fed == [0, 1, 2]
    assert ring_run["feed"]["transport"] == "shm"
    assert ring_run["feed"]["columnar"]
    mgr_run, fed, during, _ = _spark_mnist(mgr_dir, {"TFOS_SHM_FEED": "0"})
    assert not during and fed == [0, 1, 2]
    assert mgr_run["feed"]["transport"] == "manager"
    assert len(ring_run["losses"]) == 6
    assert ring_run["losses"] == mgr_run["losses"]
