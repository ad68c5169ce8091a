"""PyTorch port, record IO (``tensorflowonspark_tpu_torch.recordio``)
against the JAX package's, on the same seeded inputs:

- crc32c on the known vectors, from the port's Python codec and its
  native library;
- ``encode_example`` byte for byte equal to the JAX package's for
  seeded float, int64 and bytes features, scalar and list, from the
  port's native and Python codecs alike, and ``decode_example`` equal;
- files written by either package's ``TFRecordWriter`` read back equal
  in the other, with either codec;
- corrupt and truncated framing raise IOError, as the JAX package's
  native reader does (its Python codec raises struct.error for a record
  cut inside its trailing crc; the port's raises IOError);
- ``load_columnar``, native and fallback, equal to the JAX package's on
  the same file, the ragged fallback, a repeated key, a mixed-kind
  feature, a directory;
- a seeded decoder fuzz: no crash, and the same outcome as the JAX
  package's decoder.

``codec`` runs each case with both packages' native libraries and with
both packages' Python codecs (the libraries' loaders patched to report
them absent), so like is held against like: the JAX package's two codecs
differ on a Feature that mixes kinds.
"""

import struct

import numpy as np
import pytest

pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu import recordio as J  # noqa: E402
from tensorflowonspark_tpu.recordio import native as JN  # noqa: E402
from tensorflowonspark_tpu.recordio import pyimpl as JP  # noqa: E402
from tensorflowonspark_tpu_torch import recordio as R  # noqa: E402
from tensorflowonspark_tpu_torch.recordio import (  # noqa: E402
    pyimpl as RP,
    tfrecord_native,
)


@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(tfrecord_native, "load", lambda: None)
        monkeypatch.setattr(JN, "load", lambda: None)
    assert R.codec() == request.param
    return request.param


def _features(seed):
    """Seeded features of every kind, one value and several."""
    rng = np.random.default_rng(seed)
    return {
        "f1": ("float", [float(np.float32(rng.standard_normal()))]),
        "fn": ("float", rng.standard_normal(7).astype(np.float32).tolist()),
        "i1": ("int64", [int(rng.integers(-2 ** 62, 2 ** 62))]),
        "in": ("int64", [int(v) for v in rng.integers(-2 ** 40, 2 ** 40, 5)]
               + [-1, 0, 127, 128, 2 ** 63 - 1, -2 ** 63]),
        "b1": ("bytes", [rng.bytes(int(rng.integers(0, 300)))]),
        "bn": ("bytes", [rng.bytes(int(n)) for n in rng.integers(0, 40, 4)]
               + [b""]),
        "empty": ("float", []),
    }


def test_crc32c_known_vectors():
    lib = tfrecord_native.load()
    assert lib is not None, tfrecord_native.error()
    for data, want in ((b"\x00" * 32, 0x8A9136AA),
                       (b"123456789", 0xE3069283), (b"", 0)):
        assert RP.crc32c(data) == JP.crc32c(data) == want
        assert lib.tfr_crc32c(data, len(data)) == want
    blob = np.random.default_rng(0).bytes(100_003)
    assert lib.tfr_crc32c(blob, len(blob)) == RP.crc32c(blob)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_examples_are_byte_identical_to_jax(codec, seed):
    feats = _features(seed)
    got = R.encode_example(feats)
    assert got == J.encode_example(feats) == JP.encode_example(feats)
    assert RP.encode_example(feats) == got
    assert R.decode_example(got) == JP.decode_example(got)
    assert R.decode_example(got)["in"] == feats["in"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_read_back_in_the_other_package(codec, writer, tmp_path):
    records = [J.encode_example(_features(s)) for s in range(4)] \
        + [b"", b"x" * 100_000]
    path = str(tmp_path / "part-r-00000")
    w_cls = J.TFRecordWriter if writer == "jax" else R.TFRecordWriter
    with w_cls(path) as w:
        for r in records:
            w.write(r)
    reader = R.TFRecordReader if writer == "jax" else J.TFRecordReader
    assert list(reader(path)) == records
    assert list(R.TFRecordReader("file://" + path)) == records


@pytest.mark.parametrize("damage", ["data", "length", "truncate"])
def test_corrupt_framing_raises_as_jax_does(codec, damage, tmp_path):
    path = tmp_path / "bad"
    with R.TFRecordWriter(str(path)) as w:
        w.write(b"payload-payload")
    raw = bytearray(path.read_bytes())
    if damage == "data":
        raw[14] ^= 0xFF
    elif damage == "length":
        raw[0] ^= 0x01
    else:
        raw = raw[:-3]
    path.write_bytes(bytes(raw))
    # the JAX package's Python codec raises struct.error for a record cut
    # inside its trailing crc (ROADMAP.md queue 3)
    with pytest.raises((IOError, struct.error)):
        list(J.TFRecordReader(str(path)))
    with pytest.raises(IOError):
        list(R.TFRecordReader(str(path)))
    with pytest.raises(IOError):
        R.load_columnar(str(path))


def _write(path, examples):
    with J.TFRecordWriter(str(path)) as w:
        for feats in examples:
            w.write(JP.encode_example(feats))


def _same_columns(got, want):
    assert sorted(got) == sorted(want)
    for name, (kind, col) in want.items():
        gkind, gcol = got[name]
        assert gkind == kind, name
        if isinstance(col, np.ndarray):
            assert isinstance(gcol, np.ndarray) and gcol.dtype == col.dtype
            np.testing.assert_array_equal(gcol, col, err_msg=name)
        else:
            assert gcol == col, name


def test_load_columnar_equals_jax(codec, tmp_path):
    rng = np.random.default_rng(3)
    n = 40
    vecs = rng.random((n, 16)).astype(np.float32)
    path = tmp_path / "part-r-00000"
    _write(path, [{"vec": ("float", vecs[i].tolist()),
                   "label": ("int64", [int(i) - 7]),
                   "pair": ("int64", [i, 2 * i]),
                   "name": ("bytes", [f"r{i}".encode()]),
                   "tags": ("bytes", [b"a", rng.bytes(3)])}
                  for i in range(n)])
    got = R.load_columnar(str(path))
    _same_columns(got, J.load_columnar(str(path)))
    assert got["vec"][1].shape == (n, 16) and got["pair"][1].shape == (n, 2)
    np.testing.assert_array_equal(got["vec"][1], vecs)
    # the per-row fallback gives the native loader's columns
    _same_columns(R._columnar_fallback(str(path)), got)


def test_load_columnar_ragged_repeated_and_mixed_fall_back(codec, tmp_path):
    ragged = tmp_path / "ragged"
    _write(ragged, [{"vec": ("float", [1.0, 2.0])}, {"vec": ("float", [3.0])}])
    got = R.load_columnar(str(ragged))
    assert got == J.load_columnar(str(ragged))
    assert got["vec"] == ("float", [[1.0, 2.0], 3.0])

    # two Examples concatenated are one Example with key "x" twice: the C
    # loader refuses it, the per-row fallback keeps the last value
    repeated = tmp_path / "repeated"
    with R.TFRecordWriter(str(repeated)) as w:
        w.write(RP.encode_example({"x": ("int64", [1])})
                + RP.encode_example({"x": ("int64", [2])}))
    _same_columns(R.load_columnar(str(repeated)),
                  J.load_columnar(str(repeated)))
    assert R.load_columnar(str(repeated))["x"][1].tolist() == [2]

    # a Feature that mixes float_list and int64_list under one key
    floats = RP._len_delim(1, np.float32(1.0).tobytes())
    ints = RP._len_delim(1, RP._varint(1) + RP._varint(2))
    entry = RP._len_delim(1, b"x") + RP._len_delim(
        2, RP._len_delim(2, floats) + RP._len_delim(3, ints))
    mixed = tmp_path / "mixed"
    with R.TFRecordWriter(str(mixed)) as w:
        w.write(RP._len_delim(1, RP._len_delim(1, entry)))
    _same_columns(R.load_columnar(str(mixed)), J.load_columnar(str(mixed)))

    drift = tmp_path / "drift"
    _write(drift, [{"x": ("int64", [1])}, {"y": ("int64", [2])}])
    with pytest.raises(ValueError, match="schema"):
        R.load_columnar(str(drift))
    with pytest.raises(IsADirectoryError):
        R.load_columnar(str(tmp_path))


def _outcome(decode, data):
    try:
        return decode(data)
    except (ValueError, OverflowError, IndexError, UnicodeDecodeError,
            TypeError, KeyError):
        return "raised"


def test_decoder_fuzz_no_crash_and_jax_outcome():
    """Seeded flips, truncations and insertions of an Example: the
    port's native decoder raises or returns, never corrupts memory, and
    gives the JAX package's native decoder's outcome; the C columnar
    loader survives the same bytes framed in a file."""
    import os
    import tempfile

    lib = tfrecord_native.load()
    assert lib is not None, tfrecord_native.error()
    rng = np.random.default_rng(7)
    base = R.encode_example(_features(0))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fuzz")
        for case in range(300):
            buf = bytearray(base)
            for _ in range(rng.integers(1, 6)):
                op = rng.integers(0, 3)
                if op == 0 and len(buf) > 1:
                    buf[rng.integers(0, len(buf))] ^= rng.integers(1, 256)
                elif op == 1 and len(buf) > 2:
                    del buf[rng.integers(1, len(buf)):]
                else:
                    pos = rng.integers(0, len(buf) + 1)
                    buf[pos:pos] = bytes(rng.integers(0, 256,
                                                      rng.integers(1, 5)))
            data = bytes(buf)
            got = _outcome(R.decode_example, data)
            assert got == _outcome(J.decode_example, data), case
            if case % 10 == 0:
                with R.TFRecordWriter(path) as w:
                    w.write(data)
                h = lib.tfr_load_columnar(path.encode())
                lib.colb_free(h)
