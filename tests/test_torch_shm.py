"""PyTorch port, the shared-memory feed ring (``recordio.shm`` over
``native/shmqueue.cpp``) on the CPU: the port's copies of
tests/test_shmqueue.py and tests/test_feed_terminate.py, and the wire
across the packages: a ring written by either package reads back equal
in the other (an image ColumnChunk and a row chunk of strings, both
directions).

The port's library builds at first use into ``build/torch_native/``
(``g++``, under a flock); the JAX side builds its own through ``make``,
as its tests do.  The JAX ``test_throughput_smoke`` is a correctness
check here: no wall-clock assertion.
"""

import multiprocessing as mp
import os
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch import marker, node  # noqa: E402
from tensorflowonspark_tpu_torch.recordio import shm  # noqa: E402


def _name(tag):
    return f"/tfosq-torch-{os.getpid()}-{tag}"


def test_basic_roundtrip():
    q = shm.ShmQueue(_name("a"), capacity=1 << 16, create=True)
    try:
        q.put({"x": 1, "data": b"abc"})
        q.put_bytes(b"raw")
        q.put_bytes(b"")  # empty payload is data, not EOF
        assert q.get() == {"x": 1, "data": b"abc"}
        assert q.get_bytes() == b"raw"
        assert q.get_bytes() == b""
        q.close_write()
        assert q.get() is None  # EOF after close + drain
    finally:
        q.close()


def test_wraparound_many_messages():
    q = shm.ShmQueue(_name("b"), capacity=1 << 12, create=True)
    try:
        payload = b"z" * 500
        for i in range(100):  # far more data than capacity
            q.put_bytes(payload + str(i).encode(), timeout_ms=1000)
            assert q.get_bytes(timeout_ms=1000) == payload + str(i).encode()
    finally:
        q.close()


def test_full_queue_times_out():
    q = shm.ShmQueue(_name("c"), capacity=1 << 12, create=True)
    try:
        with pytest.raises(ValueError, match="capacity"):
            q.put_bytes(b"x" * (1 << 13))  # bigger than the ring
        q.put_bytes(b"x" * 3000)
        with pytest.raises(TimeoutError):
            q.put_bytes(b"y" * 3000, timeout_ms=100)
    finally:
        q.close()


def _producer(name, n):
    q = shm.ShmQueue(name, create=False)
    for i in range(n):
        q.put_bytes(b"msg-%06d" % i)
    q.close_write()
    q.close()


def test_cross_process_stream():
    name = _name("d")
    q = shm.ShmQueue(name, capacity=1 << 14, create=True)
    try:
        n = 5000
        p = mp.get_context("spawn").Process(target=_producer, args=(name, n))
        p.start()
        got = 0
        while True:
            data = q.get_bytes(timeout_ms=30000)
            if data is None:
                break
            assert data == b"msg-%06d" % got
            got += 1
        assert got == n
        p.join(10)
        assert p.exitcode == 0
    finally:
        q.close()


def _make_chunk(n=24, hw=6):
    rng = np.random.default_rng(0)
    rows = [(rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8), int(i))
            for i in range(n)]
    chunk = node._make_chunk_encoder()(rows)
    assert isinstance(chunk, marker.ColumnChunk)  # precondition
    return rows, chunk


def test_columnar_fast_path_roundtrip():
    """ColumnChunk -> scatter-gather push -> columnar frame -> pop into an
    owned buffer: exact bytes back, shapes intact, every column 8-byte
    aligned and a view of one buffer; pickled messages share the ring."""
    q = shm.ShmQueue(_name("f"), capacity=1 << 22, create=True)
    try:
        rows, chunk = _make_chunk()
        q.put(chunk)
        q.put(["legacy", ("row", 1)])
        q.put(marker.EndPartition())
        q.put(None)

        got = q.get(timeout_ms=5000)
        assert isinstance(got, marker.ColumnChunk)
        assert got.spec == chunk.spec and got.shapes == chunk.shapes
        for a, b in zip(got.columns, chunk.columns):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            assert a.ctypes.data % 8 == 0, "column view not 8-byte aligned"
        assert got.columns[0].base is not None  # a view, not a copy

        assert q.get(timeout_ms=5000) == ["legacy", ("row", 1)]
        assert isinstance(q.get(timeout_ms=5000), marker.EndPartition)
        assert q.get(timeout_ms=5000) is None
    finally:
        q.close()


def test_columnar_fast_path_wraparound_stream():
    """Columnar frames through a ring smaller than their total volume
    (wrap-around inside the scatter-gather push): each decodes exactly,
    and a popped chunk stays intact while later pops reuse the ring."""
    q = shm.ShmQueue(_name("g"), capacity=1 << 16, create=True)
    try:
        _, chunk = _make_chunk(n=12, hw=4)
        kept = []
        for _ in range(200):
            q.put(chunk, timeout_ms=2000)
            got = q.get(timeout_ms=2000)
            for a, b in zip(got.columns, chunk.columns):
                np.testing.assert_array_equal(a, b)
            kept.append(got)
        for got in kept[::50]:
            np.testing.assert_array_equal(got.columns[0], chunk.columns[0])
    finally:
        q.close()


def _columnar_producer(name, n):
    q = shm.ShmQueue(name, create=False, producer=True)
    _, chunk = _make_chunk(n=16, hw=5)
    for _ in range(n):
        q.put(chunk, timeout_ms=30000)
    q.put(None)
    q.close_write()
    q.close()


def test_columnar_cross_process_stream():
    name = _name("h")
    q = shm.ShmQueue(name, capacity=1 << 20, create=True)
    try:
        p = mp.get_context("spawn").Process(target=_columnar_producer,
                                            args=(name, 50))
        p.start()
        _, want = _make_chunk(n=16, hw=5)
        got_n = 0
        while True:
            item = q.get(timeout_ms=30000)
            if item is None:
                break
            for a, b in zip(item.columns, want.columns):
                np.testing.assert_array_equal(a, b)
            got_n += 1
        assert got_n == 50
        p.join(10)
        assert p.exitcode == 0
    finally:
        q.close()


def test_megabyte_messages_round_trip():
    """The JAX package's throughput smoke without its clock: 64 messages
    of 1 MiB each, each distinct, come back byte for byte."""
    q = shm.ShmQueue(_name("e"), capacity=64 << 20, create=True)
    try:
        for i in range(64):
            msg = bytes([i]) * (1 << 20)
            q.put_bytes(msg)
            assert q.get_bytes() == msg
    finally:
        q.close()


def test_close_unlinks_the_segment_and_its_lock_file():
    """The creator's close() unlinks the segment (no /dev/shm entry
    left) and the producer flock's file; a producer's close does not."""
    name = _name("u")
    ring = shm.ShmQueue(name, capacity=1 << 12, create=True)
    prod = shm.ShmQueue(name, create=False, producer=True)
    prod.put([1])
    prod.close()
    assert os.path.exists("/dev/shm" + name)
    assert os.path.exists(shm._lock_path(name))
    assert ring.get(1000) == [1]
    ring.close()
    assert not os.path.exists("/dev/shm" + name)
    assert not os.path.exists(shm._lock_path(name))


def test_creating_a_ring_larger_than_dev_shm_fails_cleanly(monkeypatch):
    """tmpfs reserves nothing: a ring larger than /dev/shm's free space
    is refused at creation, not met with SIGBUS mid-put."""
    monkeypatch.setattr(shm, "shm_free_bytes", lambda: 1 << 20)
    with pytest.raises(OSError, match="free"):
        shm.ShmQueue(_name("big"), capacity=2 << 20, create=True)
    assert not os.path.exists("/dev/shm" + _name("big"))


# -- the drain protocol (tests/test_feed_terminate.py) -------------------------

class FakeMgr:
    """KV + queue stub speaking the manager protocol DataFeed and the
    feeder use."""

    def __init__(self, kv=None):
        self.kv = dict(kv or {})

    def get(self, key):
        return self.kv.get(key)

    def set(self, key, value):
        self.kv[key] = value

    def get_queue(self, name):
        if name == "error":  # the feeder polls this

            class _Empty:
                @staticmethod
                def empty():
                    return True

            return _Empty()
        raise AssertionError("ring path must not touch manager data queues")

    queue = get_queue


def test_producer_active_tracks_flock():
    name = _name("ta")
    ring = shm.ShmQueue(name, capacity=1 << 14, create=True)
    try:
        assert not shm.producer_active(name)
        prod = shm.ShmQueue(name, create=False, producer=True)
        assert shm.producer_active(name)
        prod.close()
        assert not shm.producer_active(name)
    finally:
        ring.close()


def test_terminate_waits_for_slow_producer():
    """A producer stalled longer than any drain poll mid-partition is
    still drained before terminate() returns."""
    from tensorflowonspark_tpu_torch.feed import DataFeed

    name = _name("tb")
    ring = shm.ShmQueue(name, capacity=1 << 14, create=True)
    mgr = FakeMgr({"shm_input": name})
    drained = []

    def producer():
        q = shm.ShmQueue(name, create=False, producer=True)
        q.put(["r1"])
        time.sleep(3.0)  # longer than two drain polls
        q.put(["r2"])
        q.close()

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.2)  # let the producer take the flock
    try:
        feed = DataFeed(mgr)
        orig_get = feed._ring.get

        def spy_get(timeout_ms=-1):
            v = orig_get(timeout_ms)
            drained.append(v)
            return v

        feed._ring.get = spy_get
        feed.terminate()
        assert mgr.kv["state"] == "terminating"
        assert ["r1"] in drained and ["r2"] in drained
        assert feed._ring.qsize_bytes() == 0
    finally:
        t.join(10)
        ring.close()


def test_terminate_while_prefetch_thread_blocked():
    """terminate() while a prefetch thread is blocked inside next_batch:
    the blocked get turns into end-of-feed, the drain absorbs what comes
    later, and the single-consumer ring never sees two readers."""
    from tensorflowonspark_tpu_torch.feed import DataFeed
    from tensorflowonspark_tpu_torch.infeed import batch_iterator

    name = _name("td")
    ring = shm.ShmQueue(name, capacity=1 << 16, create=True)
    mgr = FakeMgr({"shm_input": name})
    prod = shm.ShmQueue(name, create=False, producer=True)
    try:
        for i in range(3):
            prod.put([(float(i),)] * 8)
        feed = DataFeed(mgr)
        got = []
        done = threading.Event()

        def consume():
            for b in batch_iterator(feed, 8):
                got.append(b)
            done.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        deadline = time.time() + 10
        while len(got) < 3 and time.time() < deadline:
            time.sleep(0.05)
        assert len(got) == 3, got
        term_done = threading.Event()

        def do_term():
            feed.terminate()
            term_done.set()

        threading.Thread(target=do_term, daemon=True).start()
        time.sleep(0.4)  # flag set; the consumer left its pending get
        prod.put([(99.0,)] * 8)  # data the drain absorbs
        prod.close()  # release the flock so the drain can finish
        assert term_done.wait(10), "terminate did not finish draining"
        assert done.wait(5), "prefetch thread did not exit after terminate"
        assert len(got) == 3
        assert feed.should_stop()
        assert ring.qsize_bytes() == 0
    finally:
        prod.close()
        ring.close()


def test_feeder_put_bails_on_termination(monkeypatch):
    """A feeder blocked on a full ring notices state='terminating' and
    returns, with the stop handshake, instead of waiting on a consumer
    that stopped draining."""
    name = _name("tc")
    ring = shm.ShmQueue(name, capacity=1 << 12, create=True)
    mgr = FakeMgr({"shm_input": name, "state": "running"})
    stops = []

    class FakeClient:
        def __init__(self, addr):
            pass

        def request_stop(self):
            stops.append(True)

    monkeypatch.setenv("TFOS_FEED_CHUNK", "4")
    monkeypatch.setattr(node, "_get_manager", lambda *a, **kw: mgr)
    monkeypatch.setattr(node, "read_executor_id", lambda *a, **kw: 0)
    monkeypatch.setattr(node.rendezvous, "Client", FakeClient)

    feeder = node.train({}, {"server_addr": ("127.0.0.1", 0)},
                        feed_timeout=30)
    records = [b"x" * 256] * 200  # far more than the 4 KiB ring holds
    done = threading.Event()

    def run():
        feeder(iter(records))
        done.set()

    threading.Thread(target=run, daemon=True).start()
    time.sleep(1.0)  # the feeder is now blocked on the full ring
    assert not done.is_set()
    mgr.kv["state"] = "terminating"
    assert done.wait(15), "feeder did not bail after termination"
    assert stops, "feeder skipped the stop handshake"
    assert mgr.kv["feed_stats"][-1]["terminated"]
    ring.close()


# -- the wire across the packages ---------------------------------------------

def _jax_shm():
    from tensorflowonspark_tpu.recordio import shm as jshm

    assert jshm.available(), "the JAX package's native library did not build"
    return jshm


def _image_rows():
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 256, (224, 224, 3), dtype=np.uint8), int(i))
            for i in range(4)]


def _string_rows():
    return [("hello", 1, b"\x00bytes"), ("world", 2, b"")]


def _assert_chunks_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "ColumnChunk"
    assert [tuple(s) for s in got.spec] == [tuple(s) for s in want.spec]
    assert got.shapes == want.shapes
    for a, b in zip(got.columns, want.columns):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rows", ["image", "strings"])
def test_jax_ring_to_port_ring(rows):
    """A chunk made by the JAX package's encoder and pushed by its ring
    pops equal in the port: columns, shapes and dtypes of an image
    ColumnChunk; the row list of a chunk with string fields."""
    from tensorflowonspark_tpu import node as jnode

    jshm = _jax_shm()
    records = _image_rows() if rows == "image" else _string_rows()
    chunk = jnode._make_chunk_encoder()(list(records))
    name = _name(f"jx-{rows}")
    ring = shm.ShmQueue(name, capacity=1 << 22, create=True)
    try:
        prod = jshm.ShmQueue(name, create=False, producer=True)
        prod.put(chunk)
        prod.put(None)
        prod.close()
        got = ring.get(5000)
        if rows == "image":
            assert isinstance(got, marker.ColumnChunk)
            _assert_chunks_equal(got, chunk)
        else:
            assert got == records
        assert ring.get(5000) is None
    finally:
        ring.close()


@pytest.mark.parametrize("rows", ["image", "strings"])
def test_port_ring_to_jax_ring(rows):
    """The reverse: the port's encoder and ring, the JAX package's ring
    and DataFeed-facing types on the other end."""
    from tensorflowonspark_tpu import marker as jmarker

    jshm = _jax_shm()
    records = _image_rows() if rows == "image" else _string_rows()
    chunk = node._make_chunk_encoder()(list(records))
    name = _name(f"px-{rows}")
    ring = jshm.ShmQueue(name, capacity=1 << 22, create=True)
    try:
        prod = shm.ShmQueue(name, create=False, producer=True)
        prod.put(chunk)
        prod.close()
        got = ring.get(5000)
        if rows == "image":
            assert isinstance(got, jmarker.ColumnChunk)
            _assert_chunks_equal(got, chunk)
        else:
            assert got == records
    finally:
        ring.close()
        # the JAX package's creator leaves the producer flock's file
        os.unlink(shm._lock_path(name))
