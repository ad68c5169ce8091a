"""The shared-memory feed ring: ``ShmQueue`` over ``native/shmqueue.cpp``.

The port's own copy of ``tensorflowonspark_tpu/recordio/shm.py``.  The
node creates one ring per executor; the feeder tasks push chunks into it
and the trainer pops them, with no per-chunk trip through the manager
process.  ``put`` writes a ``ColumnChunk`` as a columnar frame (magic
``TFC\\x01``, a small pickled header, then every column's raw bytes,
each 8-byte aligned) with one scatter-gather memcpy from the numpy
buffers into the ring; everything else (row lists, markers, None) is
pickled.  ``get`` pops each message into a fresh ``np.empty`` buffer
that it owns, and a columnar frame's columns come back as views over
that buffer.  The ring and the frames are the JAX package's byte for
byte, so either package reads what the other wrote.

The ring is single-producer / single-consumer.  Producers take an
exclusive flock for their session (``producer=True``), so feeder tasks
that share an executor take turns, and ``producer_active`` tells a
draining consumer whether one is still mid-partition.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import tempfile
import time

import numpy as np

from tensorflowonspark_tpu_torch import marker
from tensorflowonspark_tpu_torch.recordio import native as _native

# cannot collide with a pickle stream (protocol 2+ starts with b'\x80'),
# so pickled and columnar messages share one ring
_COLMAGIC = b"TFC\x01"
_PAD8 = b"\0" * 8
_HEADER_BYTES = 40  # sizeof(Header) in shmqueue.cpp, ahead of the ring
_SHM_DIR = "/dev/shm"


def _align8(n):
    return (n + 7) & ~7


def _decode_columnar(buf):
    """A ColumnChunk from a columnar frame: its columns are views over
    ``buf``, which they keep alive through ``.base``."""
    hlen = int.from_bytes(bytes(buf[4:8]), "little")
    hdr = pickle.loads(bytes(buf[8:8 + hlen]))
    spec, shapes, descrs = hdr[:3]
    meta = hdr[3] if len(hdr) > 3 else None
    off = _align8(8 + hlen)
    cols = []
    mv = memoryview(buf)
    for dtype_str, shape in descrs:
        dt = np.dtype(dtype_str)
        count = 1
        for s in shape:
            count *= s
        a = np.frombuffer(mv, dtype=dt, count=count, offset=off)
        cols.append(a.reshape(shape))
        off = _align8(off + a.nbytes)
    return marker.ColumnChunk(spec, tuple(cols), shapes=shapes, meta=meta)


def _lock_path(name):
    """The producer flock's file (the JAX package's name for it, so a
    producer of either package excludes the other's)."""
    return os.path.join(tempfile.gettempdir(),
                        f".tfosq{name.replace('/', '_')}.lock")


def producer_active(name):
    """True while some producer holds the ring's producer flock: lets a
    draining consumer tell "empty for now, a feeder is mid-partition"
    from "no more data coming" without a timeout guess."""
    import fcntl

    try:
        f = open(_lock_path(name), "w")
    except OSError:
        return False
    try:
        fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        fcntl.flock(f, fcntl.LOCK_UN)
        return False
    except OSError:
        return True
    finally:
        f.close()


def shm_free_bytes():
    """Free bytes of ``/dev/shm``, where POSIX shared memory lives, or
    None where it is not a directory."""
    try:
        st = os.statvfs(_SHM_DIR)
    except OSError:
        return None
    return st.f_bavail * st.f_frsize


class ShmQueue:
    """The creator, a producer or the consumer of a named ring.

    ``create=True`` makes the segment (``capacity`` bytes of ring) and
    unlinks it on ``close()``; creating fails with OSError when
    ``/dev/shm`` has less free space than the segment, because tmpfs
    reserves nothing and a full one would kill a writer with SIGBUS
    mid-put.  ``producer=True`` takes the producer flock (blocking, or
    BlockingIOError with ``producer_nonblock``)."""

    def __init__(self, name, capacity=64 << 20, create=False,
                 open_timeout_ms=60000, producer=False,
                 producer_nonblock=False):
        lib = _native.load()
        if lib is None:
            raise RuntimeError(f"shm ring library unavailable: "
                               f"{_native.error()}")
        self._lib = lib
        self.name = name
        self.created = create
        self.last_pop_s = None  # the last get's copy and decode, seconds
        self._h = None
        self._lockf = None
        if create:
            need = _align8(capacity) + _HEADER_BYTES
            free = shm_free_bytes()
            if free is not None and free < need:
                raise OSError(f"shm queue {name}: {_SHM_DIR} has {free} "
                              f"bytes free, the ring needs {need} (lower "
                              f"TFOS_SHM_FEED_BYTES or enlarge {_SHM_DIR})")
        if producer and not create:
            import fcntl

            self._lockf = open(_lock_path(name), "w")
            try:
                fcntl.flock(self._lockf, fcntl.LOCK_EX | (
                    fcntl.LOCK_NB if producer_nonblock else 0))
            except OSError:
                self._lockf.close()
                self._lockf = None
                raise BlockingIOError(f"shm queue {name}: producer flock "
                                      "held by another session") from None
        if create:
            self._h = lib.shq_create(name.encode(), capacity)
        else:
            self._h = lib.shq_open(name.encode(), open_timeout_ms)
        if not self._h:
            if self._lockf:
                self._lockf.close()
                self._lockf = None
            raise OSError(f"cannot {'create' if create else 'open'} shm "
                          f"queue {name}")

    def _check_push(self, rc, nbytes):
        if rc == -1:
            raise TimeoutError(f"shm queue {self.name} full")
        if rc == -2:
            raise BrokenPipeError(f"shm queue {self.name} closed")
        if rc == -3:
            raise ValueError(f"message of {nbytes} bytes larger than shm "
                             f"queue {self.name}'s capacity "
                             "(TFOS_SHM_FEED_BYTES)")

    def put_bytes(self, data: bytes, timeout_ms=-1):
        self._check_push(self._lib.shq_push(self._h, data, len(data),
                                            timeout_ms), len(data))

    def get_bytes(self, timeout_ms=-1):
        """The next payload (possibly b""), or None at end of stream."""
        n = self._lib.shq_pop(self._h, timeout_ms)
        if n == -1:
            raise TimeoutError(f"shm queue {self.name} empty")
        if n == -2:
            return None  # closed and drained
        return ctypes.string_at(self._lib.shq_buffer(self._h), n) if n \
            else b""

    def put(self, obj, timeout_ms=-1):
        """Push one object: a ColumnChunk of contiguous numeric columns
        as a columnar frame, anything else pickled."""
        if not self._put_columnar(obj, timeout_ms):
            self.put_bytes(pickle.dumps(obj,
                                        protocol=pickle.HIGHEST_PROTOCOL),
                           timeout_ms)

    def get(self, timeout_ms=-1):
        """Pop one object (TimeoutError when none came in time, None at
        end of stream).  The message is copied once, into a buffer this
        call allocates and the result owns: a later pop never reuses it,
        so views over it stay valid while anything holds them."""
        n = self._lib.shq_peek_len(self._h, timeout_ms)
        if n == -1:
            raise TimeoutError(f"shm queue {self.name} empty")
        if n == -2:
            return None  # closed and drained
        t0 = time.perf_counter()
        # np.empty, not bytearray: bytearray(n) zero-fills, a hidden
        # extra write of the whole payload
        buf = np.empty(n, np.uint8)
        got = self._lib.shq_pop_into(
            self._h, ctypes.c_void_p(buf.ctypes.data) if n else None)
        if got != n:  # single-consumer contract broken
            raise RuntimeError(f"shm queue {self.name}: peeked {n} bytes "
                               f"but popped {got} (a second consumer?)")
        if n >= 4 and bytes(buf[:4]) == _COLMAGIC:
            obj = _decode_columnar(buf)
        else:
            obj = pickle.loads(memoryview(buf) if n else b"")
        self.last_pop_s = time.perf_counter() - t0
        return obj

    def _put_columnar(self, obj, timeout_ms):
        """Scatter-gather push of a ColumnChunk; False when ``obj`` is not
        one, or a column is an object or non-contiguous array, so that
        put() pickles it instead."""
        if not isinstance(obj, marker.ColumnChunk):
            return False
        cols = obj.columns
        if not cols or any(not isinstance(a, np.ndarray) or a.dtype.hasobject
                           or not a.flags.c_contiguous for a in cols):
            return False
        header = pickle.dumps(
            (obj.spec, obj.shapes, [(a.dtype.str, a.shape) for a in cols],
             obj.meta), protocol=pickle.HIGHEST_PROTOCOL)
        # pad so every column starts 8-byte aligned in the frame: the
        # consumer views the columns in place
        segs = [_COLMAGIC, len(header).to_bytes(4, "little"), header]
        off = 8 + len(header)
        if off % 8:
            segs.append(_PAD8[:8 - off % 8])
        for a in cols:
            segs.append(a)
            if a.nbytes % 8:
                segs.append(_PAD8[:8 - a.nbytes % 8])
        n = len(segs)
        ptrs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_uint64 * n)()
        keep = []  # every buffer stays referenced until the push returns
        for i, s in enumerate(segs):
            if isinstance(s, np.ndarray):
                ptrs[i], lens[i] = s.ctypes.data, s.nbytes
            else:
                b = ctypes.create_string_buffer(s, len(s))
                keep.append(b)
                ptrs[i], lens[i] = ctypes.addressof(b), len(s)
        nbytes = sum(lens)
        self._check_push(self._lib.shq_push_iov(self._h, ptrs, lens, n,
                                                timeout_ms), nbytes)
        return True

    def close_write(self):
        """Mark the stream ended: the consumer drains, then gets None."""
        self._lib.shq_close_write(self._h)

    def qsize_bytes(self):
        """Bytes written and not yet popped."""
        return self._lib.shq_size(self._h)

    def close(self):
        """Unmap the ring (the creator also unlinks it, and the producer
        flock's file) and release the producer flock."""
        if self._h:
            self._lib.shq_free(self._h)
            self._h = None
            if self.created:
                try:
                    os.unlink(_lock_path(self.name))
                except OSError:
                    pass
        if self._lockf:
            self._lockf.close()
            self._lockf = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def unlink(name):
    """Remove a ring whose creator died without closing it: its segment
    and its producer flock's file.  True when the segment was there."""
    try:
        os.unlink(_lock_path(name))
    except OSError:
        pass
    try:
        os.unlink(os.path.join(_SHM_DIR, name.lstrip("/")))
    except FileNotFoundError:
        return False
    return True


def available():
    """True when the ring's library built and loaded."""
    return _native.load() is not None
