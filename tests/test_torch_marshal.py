"""PyTorch port, the row <-> column marshal (``recordio.marshal``, its
``native/marshal.c`` extension built at first use into
``build/torch_native/``) on the CPU: the port's copy of
tests/test_marshal.py over the whole dtype matrix, native and numpy
alike, and the port's results held equal to the JAX package's on the
same seeded rows.  The JAX ``test_native_beats_numpy_path`` is a
correctness check here (native equals numpy on its batch): no
wall-clock assertion.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch.recordio import marshal  # noqa: E402

ROWS = [
    (True, 1, 2**40, 1.5, 2.5, [True, False], [1, 2], [2**40, 3], [0.5, 1.5],
     [2.5, 3.5]),
    (False, 4, 2**41, 4.5, 5.5, [False, True], [3, 4], [2**41, 6], [2.5, 3.5],
     [4.5, 5.5]),
]
SPEC = [("?", 0), ("i", 0), ("l", 0), ("f", 0), ("d", 0),
        ("?", 2), ("i", 2), ("l", 2), ("f", 2), ("d", 2)]
DTYPES = [np.bool_, np.int32, np.int64, np.float32, np.float64] * 2


@pytest.fixture(params=["native", "numpy"])
def impl(request, monkeypatch):
    if request.param == "native":
        assert marshal.native_available(), "the native marshal did not build"
    else:
        monkeypatch.setattr(marshal, "_ext", None)
        monkeypatch.setattr(marshal, "_ext_tried", True)
    return request.param


def test_rows_to_columns_dtype_matrix(impl):
    cols = marshal.rows_to_columns(ROWS, SPEC)
    assert len(cols) == len(SPEC)
    for arr, dt, (code, w) in zip(cols, DTYPES, SPEC):
        assert arr.dtype == np.dtype(dt), (arr.dtype, dt)
        assert arr.shape == ((2,) if w == 0 else (2, w))
    assert cols[0].tolist() == [True, False]
    assert cols[2].tolist() == [2**40, 2**41]
    assert cols[4].tolist() == [2.5, 5.5]
    assert cols[7].tolist() == [[2**40, 3], [2**41, 6]]
    np.testing.assert_allclose(cols[8], [[0.5, 1.5], [2.5, 3.5]])


def test_columns_to_rows_dtype_matrix(impl):
    cols = [np.asarray(list(col), dtype=dt)
            for col, dt in zip(zip(*ROWS), DTYPES)]
    rows = marshal.columns_to_rows(cols)
    assert len(rows) == 2
    for got, want in zip(rows, ROWS):
        assert len(got) == len(want)
        assert isinstance(got[0], bool) and got[0] == want[0]
        assert isinstance(got[2], int) and got[2] == want[2]
        assert isinstance(got[5], list)
        assert got[6] == want[6]
        np.testing.assert_allclose(got[9], want[9])


def test_roundtrip(impl):
    back = marshal.columns_to_rows(marshal.rows_to_columns(ROWS, SPEC))
    for got, want in zip(back, ROWS):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w)


def test_infer_spec():
    # python scalars widen to int64/float64 (numpy default semantics)
    assert marshal.infer_spec(ROWS[0]) == [
        ("?", 0), ("l", 0), ("l", 0), ("d", 0), ("d", 0),
        ("?", 2), ("l", 2), ("l", 2), ("d", 2), ("d", 2)]


def test_infer_spec_strings():
    assert marshal.infer_spec(("a", b"b", ["x", "y"])) == [
        ("O", 0), ("O", 0), ("O", 2)]
    cols = marshal.rows_to_columns([("a", b"b"), ("c", b"d")],
                                   [("O", 0), ("O", 0)])
    assert cols[0].dtype == object and list(cols[0]) == ["a", "c"]


def test_ragged_array_column_rejected(impl):
    with pytest.raises(ValueError):
        marshal.rows_to_columns([([1.0],), ([1.0, 2.0],)], [("d", 1)])


def test_row_arity_mismatch_rejected(impl):
    with pytest.raises(ValueError):
        marshal.rows_to_columns([(1.0, 2.0), (3.0,)], [("d", 0), ("d", 0)])


def test_lossy_casts_refused(impl):
    """Floats after an int first row, ints after a bool one: both paths
    raise, so the feeder's encoder falls back to exact row chunks."""
    with pytest.raises((TypeError, ValueError)):
        marshal.rows_to_columns([(1,), (2.9,)], [("l", 0)])
    with pytest.raises((TypeError, ValueError)):
        marshal.rows_to_columns([(True,), (2,)], [("?", 0)])


def test_numpy_bool_scalars_accepted(impl):
    cols = marshal.rows_to_columns(
        [(np.bool_(True),), (np.bool_(False),)], [("?", 0)])
    assert cols[0].dtype == np.bool_
    assert cols[0].tolist() == [True, False]


def test_int32_spec_overflow_refused(impl):
    with pytest.raises((OverflowError, ValueError)):
        marshal.rows_to_columns([(1,), (2 ** 35,)], [("i", 0)])


def test_infer_spec_int8_is_not_bool():
    spec = marshal.infer_spec((np.array([5, 0, 2], np.int8),))
    assert spec == [("b", 3)]
    cols = marshal.rows_to_columns([(np.array([5, 0, 2], np.int8),)], spec)
    assert cols[0].dtype == np.int8
    assert cols[0].tolist() == [[5, 0, 2]]


def test_narrow_uint8_column_roundtrip():
    """Image bytes keep their width: uint8 rows -> 'B' -> a uint8 column
    -> exact values back; overflow into a narrow spec is refused."""
    rows = [(np.array([0, 127, 255], np.uint8), i) for i in range(4)]
    spec = marshal.infer_spec(rows[0])
    assert spec[0] == ("B", 3)
    cols = marshal.rows_to_columns(rows, spec)
    assert cols[0].dtype == np.uint8 and cols[0].shape == (4, 3)
    assert marshal.columns_to_rows(cols)[0][0] == [0, 127, 255]
    with pytest.raises(ValueError, match="overflow"):
        marshal.rows_to_columns(
            [(np.array([5], np.int64),), (np.array([300], np.int64),)],
            [("B", 1)])


def test_infer_spec_rejects_uint64_and_multidim():
    with pytest.raises(ValueError):
        marshal.infer_spec((np.array([1], np.uint64),))
    with pytest.raises(ValueError):
        marshal.infer_spec((np.zeros((2, 2), np.float32),))


def test_schema_to_spec():
    fields = [("flag", "boolean"), ("n", "bigint"), ("x", "float"),
              ("emb", "array<double>"), ("name", "string")]
    assert marshal.schema_to_spec(fields, widths={"emb": 4}) == [
        ("?", 0), ("l", 0), ("f", 0), ("d", 4), ("O", 0)]


def test_multidim_output_keeps_nesting():
    rows = marshal.columns_to_rows(
        [np.arange(8, dtype=np.float32).reshape(2, 2, 2)])
    assert rows[0][0] == [[0.0, 1.0], [2.0, 3.0]]


def test_native_equals_numpy_on_a_realistic_batch():
    rows = [(float(i), [float(i)] * 16, i, True) for i in range(4096)]
    spec = [("d", 0), ("f", 16), ("l", 0), ("?", 0)]
    assert marshal.native_available()
    native = marshal._ext.rows_to_columns(rows, spec)
    cols = list(zip(*rows))
    plain = [np.asarray(cols[i], dtype=d) for i, d in
             enumerate([np.float64, np.float32, np.int64, np.bool_])]
    for a, b in zip(native, plain):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert marshal._ext.columns_to_rows(list(native)) == \
        [tuple(np.asarray(c).tolist() for c in r) for r in zip(*plain)]


def test_marshal_ext_fuzz_no_crash():
    """Seeded hostile inputs (wrong arity, types and dtypes, ragged
    rows, non-contiguous and >2-D arrays) raise cleanly."""
    ext = marshal._load_ext()
    assert ext is not None
    rng = np.random.default_rng(1)
    vals = [1, -1, 2 ** 40, 1.5, True, None, "x", b"y", [1, 2], [1.0],
            (), {"a": 1}, float("nan"), 2 ** 70]
    codes = ["?", "i", "l", "f", "d", "z"]
    for _ in range(400):
        ncols = rng.integers(1, 4)
        spec = [(codes[rng.integers(0, len(codes))], int(rng.integers(0, 4)))
                for _ in range(ncols)]
        rows = []
        for _ in range(rng.integers(0, 4)):
            arity = ncols if rng.integers(0, 4) else rng.integers(0, 5)
            rows.append(tuple(vals[rng.integers(0, len(vals))]
                              for _ in range(arity)))
        try:
            ext.rows_to_columns(rows, spec)
        except (TypeError, ValueError, OverflowError):
            pass
    arrs = [np.zeros((3,), np.float32), np.zeros((2, 2), np.int64),
            np.zeros((3,), np.complex64), np.zeros((0,), np.float64),
            np.zeros((2, 2, 2), np.int32), np.array(["a", "b"]),
            np.zeros((4,), np.int64)[::2]]
    for _ in range(300):
        cols = [arrs[rng.integers(0, len(arrs))]
                for _ in range(rng.integers(1, 4))]
        try:
            ext.columns_to_rows(cols)
        except (TypeError, ValueError, BufferError):
            pass


# -- against the JAX package ---------------------------------------------------

def _seeded_rows(n=64):
    """Every numeric column kind, from a seed: scalars of each code,
    fixed-width lists, and narrow-int and float32 arrays."""
    rng = np.random.default_rng(11)
    return [(bool(rng.integers(0, 2)), int(rng.integers(-2**40, 2**40)),
             float(rng.standard_normal()),
             [int(v) for v in rng.integers(-9, 9, 3)],
             [float(v) for v in rng.standard_normal(2)],
             rng.integers(0, 256, 12, dtype=np.uint8),
             rng.integers(-128, 128, 5, dtype=np.int8),
             rng.standard_normal(4).astype(np.float32))
            for _ in range(n)]


def test_rows_to_columns_and_back_equal_the_jax_package(impl):
    from tensorflowonspark_tpu.recordio import marshal as jmarshal

    rows = _seeded_rows()
    spec = marshal.infer_spec(rows[0])
    assert spec == jmarshal.infer_spec(rows[0])
    got = marshal.rows_to_columns(rows, spec)
    want = jmarshal.rows_to_columns(rows, spec)
    assert len(got) == len(want) == len(spec)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the numeric columns the C reconstruction reads, then every column
    for cols in (got[:5], got):
        assert marshal.columns_to_rows(cols) == \
            jmarshal.columns_to_rows(cols)
