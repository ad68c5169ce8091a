"""Record IO of the port: TFRecord files, the ``tf.train.Example`` codec
and the columnar bulk loader, plus the feed's host-native transport.

The port's own copy of ``tensorflowonspark_tpu/recordio/__init__.py``.
A C++ library (``native/tfrecord.cpp`` under the port's package, bound
by ``tfrecord_native``) does the framing, crc32c and the Example wire
format; where it cannot be built the pure-Python codec (``pyimpl``)
runs, with the same results.  ``codec()`` names the one that runs.
Files and Examples are the JAX package's byte for byte, so either
package reads what the other wrote.  Local paths (and ``file://``) go
through the C library's ``FILE*`` reader and writer; remote URLs
(``gs://``, ``hdfs://``, ``s3://``, ``memory://``) are framed in memory
and moved whole through fsspec (``fs``).

The transport modules beside it: the shared-memory feed ring (``shm``,
over ``native/shmqueue.cpp``) and the row <-> column marshal
(``marshal``, over ``native/marshal.c``), both built at first use by
``_build``.

API::

    with TFRecordWriter(path) as w: w.write(b"...")
    for rec in TFRecordReader(path): ...
    encode_example({"x": ("float", [1.0])}) -> bytes
    decode_example(b) -> {"x": ("float", [1.0])}
    load_columnar(path) -> {"x": ("float", ndarray[n])}
"""

from __future__ import annotations

import ctypes
import os as _os

import numpy as _np

from tensorflowonspark_tpu_torch.recordio import fs as _fs
from tensorflowonspark_tpu_torch.recordio import pyimpl as _py
from tensorflowonspark_tpu_torch.recordio import tfrecord_native as _native


def codec():
    """``"native"`` or ``"python"``: the codec this process reads and
    writes records with."""
    return "native" if _native.load() is not None else "python"


class TFRecordWriter:
    """Writes TFRecord framing to any filesystem.

    A local path goes through the C library's buffered writer (or the
    Python codec where it is absent).  A remote URL is framed in memory
    and written with one ``fs.write_bytes`` on close: objects on these
    stores are immutable, so one terminal PUT is their write pattern."""

    def __init__(self, path):
        self._lib = _native.load()
        self._h = self._mh = self._f = None
        self._remote_path = None
        if _fs.is_local(path):
            lp = _fs.local_path(path)
            if self._lib is not None:
                self._h = self._lib.tfr_writer_open(lp.encode())
                if not self._h:
                    raise IOError(f"cannot open {lp} for writing")
            else:
                self._f = open(lp, "wb")
        elif self._lib is not None:
            self._mh = self._lib.tfr_mem_writer_new()
            self._remote_path = str(path)
        else:
            self._f = _fs.open_file(path, "wb")

    def write(self, data: bytes):
        if self._h is not None:
            if self._lib.tfr_writer_write(self._h, data, len(data)) != 0:
                raise IOError("TFRecord write failed")
        elif self._mh is not None:
            self._lib.tfr_mem_writer_write(self._mh, data, len(data))
        else:
            _py.write_record(self._f, data)

    def close(self):
        if self._h is not None:
            self._lib.tfr_writer_close(self._h)
            self._h = None
        elif self._mh is not None:
            try:
                n = ctypes.c_uint64()
                p = self._lib.tfr_mem_writer_data(self._mh, ctypes.byref(n))
                _fs.write_bytes(self._remote_path,
                                ctypes.string_at(p, n.value) if n.value
                                else b"")
            finally:
                self._lib.tfr_mem_writer_free(self._mh)
                self._mh = None
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TFRecordReader:
    """Iterates raw record bytes from one TFRecord file on any
    filesystem; corrupt or truncated framing raises IOError.  A remote
    file is read whole through fsspec and framed in memory."""

    def __init__(self, path):
        self._path = path
        self._lib = _native.load()

    def __iter__(self):
        if _fs.is_local(self._path):
            yield from self._iter_local()
        else:
            yield from self._iter_remote()

    def _iter_local(self):
        lp = _fs.local_path(self._path)
        if self._lib is None:
            with open(lp, "rb") as f:
                yield from _py.read_records(f)
            return
        h = self._lib.tfr_reader_open(lp.encode())
        if not h:
            raise IOError(f"cannot open {self._path}")
        try:
            yield from self._records(self._lib.tfr_reader_next, h)
        finally:
            self._lib.tfr_reader_close(h)

    def _iter_remote(self):
        data = _fs.read_bytes(self._path)
        if self._lib is None:
            import io

            yield from _py.read_records(io.BytesIO(data))
            return
        # the reader points into ``data``, which this frame keeps alive
        h = self._lib.tfr_mem_reader_new(data, len(data))
        try:
            yield from self._records(self._lib.tfr_mem_reader_next, h)
        finally:
            self._lib.tfr_mem_reader_free(h)

    def _records(self, next_fn, h):
        buf = ctypes.POINTER(ctypes.c_uint8)()
        while True:
            n = next_fn(h, ctypes.byref(buf))
            if n == -1:
                return  # clean EOF
            if n < -1:
                raise IOError(f"corrupt TFRecord ({n}) in {self._path}")
            yield ctypes.string_at(buf, n) if n else b""


def encode_example(features: dict) -> bytes:
    """{name: (kind, values)} -> serialized tf.train.Example."""
    lib = _native.load()
    if lib is None:
        return _py.encode_example(features)
    b = lib.exb_new()
    try:
        for name in sorted(features):
            kind, values = features[name]
            cname = name.encode()
            if kind == "int64":
                arr = (ctypes.c_int64 * len(values))(*values)
                lib.exb_add_int64(b, cname, arr, len(values))
            elif kind == "float":
                arr = (ctypes.c_float * len(values))(*values)
                lib.exb_add_float(b, cname, arr, len(values))
            elif kind == "bytes":
                bufs = (ctypes.c_char_p * len(values))(*values)
                lens = (ctypes.c_uint64 * len(values))(
                    *[len(v) for v in values])
                lib.exb_add_bytes(b, cname, bufs, lens, len(values))
            else:
                raise ValueError(f"unknown feature kind {kind!r}")
        n = ctypes.c_uint64()
        p = lib.exb_serialize(b, ctypes.byref(n))
        return ctypes.string_at(p, n.value)
    finally:
        lib.exb_free(b)


def decode_example(data: bytes) -> dict:
    """Serialized tf.train.Example -> {name: (kind, values)}."""
    lib = _native.load()
    if lib is None:
        return _py.decode_example(data)
    d = lib.exd_parse(data, len(data))
    if not d:
        raise ValueError("unparseable tf.train.Example")
    try:
        out = {}
        for i in range(lib.exd_num_features(d)):
            name = lib.exd_name(d, i).decode()
            kind = lib.exd_kind(d, i)
            cnt = lib.exd_value_count(d, i)
            if kind == 2:
                # one bulk copy of the C buffer, not a ctypes index a value
                p = lib.exd_floats(d, i)
                out[name] = ("float", _np.frombuffer(
                    ctypes.string_at(p, cnt * 4), _np.float32).tolist())
            elif kind == 3:
                p = lib.exd_int64s(d, i)
                out[name] = ("int64", _np.frombuffer(
                    ctypes.string_at(p, cnt * 8), _np.int64).tolist())
            elif kind == 1:
                vals = []
                n = ctypes.c_uint64()
                for j in range(cnt):
                    p = lib.exd_bytes(d, i, j, ctypes.byref(n))
                    vals.append(ctypes.string_at(p, n.value))
                out[name] = ("bytes", vals)
            else:
                out[name] = (None, [])
        return out
    finally:
        lib.exd_free(d)


def load_columnar(path):
    """Bulk-load one TFRecord file of tf.train.Examples into dense
    per-feature columns: {name: (kind, column)}, where a float or int64
    column is an ndarray [n] or [n, w] and a bytes column a list of
    bytes (a list of lists for multi-value features).

    One C pass over the whole file, no per-value Python objects.  The
    schema comes from the first record; a ragged or drifting file falls
    back to per-row ``decode_example`` with the same results, and so does
    every file where the native codec is absent.  Corrupt framing raises
    IOError; a directory raises IsADirectoryError (use ``dfutil``'s
    loaders for a shard directory).
    """
    local = _fs.is_local(path)
    if local and _os.path.isdir(_fs.local_path(path)):
        # fopen(dir) "succeeds" and reads nothing: a silent empty result
        raise IsADirectoryError(
            f"{path} is a directory; pass a shard file (or use "
            "dfutil.load_tfrecords_columnar / iter_tfrecords_columnar "
            "for a shard dir)")
    lib = _native.load()
    if lib is None:
        return _columnar_fallback(path)
    if local:
        h = lib.tfr_load_columnar(_fs.local_path(path).encode())
    else:  # one read through fsspec, one C pass over the bytes
        data = _fs.read_bytes(path)
        h = lib.tfr_load_columnar_mem(data, len(data))
    if not h:
        raise MemoryError("columnar load allocation failed")
    try:
        if not lib.colb_ok(h):
            err = lib.colb_error(h).decode()
            # IO errors are these fixed strings (tfrecord.cpp); every
            # other error is schema-shaped (ragged, drifting or repeated
            # features) and takes the per-row fallback
            if err == "cannot open file" or err.startswith(
                    "corrupt TFRecord framing"):
                raise IOError(f"{err}: {path}")
            return _columnar_fallback(path)
        n = lib.colb_num_rows(h)
        out = {}
        for i in range(lib.colb_num_features(h)):
            name = lib.colb_name(h, i).decode()
            kind = lib.colb_kind(h, i)
            w = lib.colb_width(h, i)
            if kind in (2, 3):
                dt = _np.float32 if kind == 2 else _np.int64
                if n * w == 0:  # an empty column's C buffer may be NULL
                    a = _np.zeros((n, w), dt)
                else:  # a view of the C buffer; copied once below
                    a = _np.ctypeslib.as_array(
                        lib.colb_floats(h, i) if kind == 2
                        else lib.colb_int64s(h, i), (n, w))
                out[name] = ("float" if kind == 2 else "int64",
                             a[:, 0].copy() if w == 1 else a.copy())
            elif kind == 1:
                offs = _np.frombuffer(
                    ctypes.string_at(lib.colb_bytes_offsets(h, i),
                                     (n * w + 1) * 8), _np.uint64)
                blob = ctypes.string_at(lib.colb_bytes_blob(h, i),
                                        int(offs[-1])) if n * w else b""
                vals = [blob[int(offs[j]):int(offs[j + 1])]
                        for j in range(n * w)]
                out[name] = ("bytes", vals if w == 1 else
                             [vals[j * w:(j + 1) * w] for j in range(n)])
            else:
                out[name] = (None, [None] * n)
        return out
    finally:
        lib.colb_free(h)


def _columnar_fallback(path):
    """Per-row decode assembled into columns (the Python codec's and the
    ragged path).  Ragged numeric features stay lists of lists;
    fixed-width ones become the arrays the native path gives."""
    names = None
    cols = {}
    kinds = {}
    n = 0
    for rec in TFRecordReader(path):
        row = decode_example(rec)
        if names is None:
            names = sorted(row)
            for name in names:
                kinds[name], _ = row[name]
                cols[name] = []
        elif set(row) != set(names):
            # surfacing drift beats silently dropping the extra features
            raise ValueError(
                f"record {n} features {sorted(row)} do not match the "
                f"first record's schema {names}; use the row-level "
                "load_tfrecords for schema-drifting files")
        for name in names:
            kind, values = row.get(name, (None, None))
            if values is None:
                raise ValueError(
                    f"record {n} is missing feature {name!r}")
            cols[name].append(values[0] if len(values) == 1 else values)
        n += 1
    out = {}
    for name in (names or []):
        vals = cols[name]
        kind = kinds[name]
        if kind in ("float", "int64"):
            widths = {1 if not isinstance(v, list) else len(v) for v in vals}
            if len(widths) == 1:
                dt = _np.float32 if kind == "float" else _np.int64
                out[name] = (kind, _np.asarray(vals, dt))
                continue
        out[name] = (kind, vals)
    return out
