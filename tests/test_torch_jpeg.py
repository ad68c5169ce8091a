"""PyTorch port, the JPEG decode of the ImageNet input path
(``recordio/jpeg.py`` over ``native/jpegdec.c``, and
``examples/imagenet_records.py``), on the CPU, against the JAX package
(``tensorflowonspark_tpu.recordio.jpeg``, ``examples/resnet/
imagenet_records.py``) over seeded JPEGs made with PIL: byte for byte

- on the native path, both decoders built against this machine's
  libjpeg, and the port's also by its second route (the vendored
  headers and the libjpeg that Pillow bundles);
- on the PIL path: the port with ``TFOS_NO_NATIVE=1`` in a subprocess or
  its library masked, the JAX module with its ``_LIB`` set to None;
- for grayscale, CMYK, PNG, ``bytearray`` and ``memoryview`` payloads,
  with truncated and corrupt streams raising ValueError in both, and
  JPEG magic winning over the raw size rule.

The cases mirror ``tests/test_jpeg.py``.
"""

import ctypes
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu.recordio import jpeg as J  # noqa: E402
from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    imagenet_records as PR,
)
from tensorflowonspark_tpu_torch.recordio import _build  # noqa: E402
from tensorflowonspark_tpu_torch.recordio import jpeg as P  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ImageNet-like sizes (the 1024x768 one takes the DCT 1/2 scale at 224),
# an exact fit, and edge shapes
SHAPES = [(375, 500), (500, 333), (768, 1024), (224, 224), (7, 5), (1, 1),
          (40, 1000), (1000, 40)]


def _smooth(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([
        128 + 100 * np.sin(xx / 40) * np.cos(yy / 60),
        128 + 80 * np.sin((xx + yy) / 50),
        128 + 60 * np.cos(xx / 30),
    ], -1).clip(0, 255).astype(np.uint8)


def _encode(arr, mode=None, fmt="JPEG", quality=90):
    from PIL import Image

    buf = io.BytesIO()
    kw = {"quality": quality} if fmt == "JPEG" else {}
    Image.fromarray(arr, mode=mode).save(buf, fmt, **kw)
    return buf.getvalue()


def _seeded(shape, seed):
    """A smooth image with seeded noise: JPEG-realistic, and different
    for every seed."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(-20, 21, shape + (3,))
    return np.clip(_smooth(*shape).astype(int) + noise, 0,
                   255).astype(np.uint8)


def _cmyk():
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((80, 60, 4), 120, np.uint8),
                    mode="CMYK").save(buf, "JPEG")
    return buf.getvalue()


def _jax_records():
    spec = importlib.util.spec_from_file_location(
        "imagenet_records",
        os.path.join(REPO, "examples", "resnet", "imagenet_records.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def native(monkeypatch, tmp_path):
    """Both packages on their native decoders, built against this
    machine's libjpeg.  Where the JAX package's ``native/`` library is
    not built, its ``jpegdec.c`` is compiled here (the same source the
    Makefile builds) and bound for the test."""
    assert P.available(), P.error()
    assert _build.jpeg_build_info()["route"] == "system"
    if not J.available():
        so = tmp_path / "libjaxjpeg.so"
        subprocess.run(["cc", "-O3", "-fPIC", "-Wall", "-shared", "-o",
                        str(so), os.path.join(REPO, "native", "jpegdec.c"),
                        "-ljpeg"], check=True)
        monkeypatch.setattr(J, "_LIB", P._bind(ctypes.CDLL(str(so))))
        monkeypatch.setattr(J, "_TRIED", True)
    assert J.available()


@pytest.fixture
def pil_only(monkeypatch):
    """Both packages on the PIL path."""
    monkeypatch.setitem(P._STATE, "lib", None)
    monkeypatch.setitem(P._STATE, "tried", True)
    monkeypatch.setattr(J, "_LIB", None)
    monkeypatch.setattr(J, "_TRIED", True)
    assert not P.available() and not J.available()


def _same_decodes(size=224):
    for i, shape in enumerate(SHAPES):
        data = _encode(_seeded(shape, i))
        got = P.decode_resized(data, size)
        assert got.shape == (size, size, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, J.decode_resized(data, size),
                                      err_msg=str(shape))
        for target in (0, size):
            np.testing.assert_array_equal(P.decode_rgb(data, target),
                                          J.decode_rgb(data, target))


def test_native_decode_equals_jax(native):
    P.reset_decode_counts()
    _same_decodes()
    assert P.decode_counts() == {"native": 3 * len(SHAPES), "pil": 0}


def test_pil_decode_equals_jax(pil_only):
    P.reset_decode_counts()
    _same_decodes()
    assert P.decode_counts() == {"native": 0, "pil": 3 * len(SHAPES)}


def test_no_native_env_decodes_through_pil_as_jax_does(monkeypatch):
    """``TFOS_NO_NATIVE=1`` is the one switch: the port's process loads
    no decoder and its bytes equal the JAX PIL path's here."""
    datas = [_encode(_seeded(s, i)) for i, s in enumerate(SHAPES[:4])]
    code = r"""
import json, sys
import numpy as np
from tensorflowonspark_tpu_torch.recordio import jpeg
datas = [bytes.fromhex(h) for h in json.load(sys.stdin)]
out = jpeg.decode_batch(datas, 64, threads=4)
print(json.dumps([jpeg.available(), jpeg.error(), jpeg.decode_counts(),
                  out.tobytes().hex()]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, TFOS_NO_NATIVE="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         input=json.dumps([d.hex() for d in datas]),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    available, why, counts, pixels = json.loads(out.stdout)
    assert (available, why) == (False, "TFOS_NO_NATIVE=1")
    assert counts == {"native": 0, "pil": 4}
    monkeypatch.setattr(J, "_LIB", None)
    monkeypatch.setattr(J, "_TRIED", True)
    np.testing.assert_array_equal(
        np.frombuffer(bytes.fromhex(pixels), np.uint8).reshape(4, 64, 64, 3),
        J.decode_batch(datas, 64))


@pytest.mark.parametrize("path", ["native", "pil_only"])
def test_odd_payloads_and_errors_equal_jax(path, request):
    """Grayscale, CMYK (the native decoder refuses it; PIL arbitrates and
    the port counts it), bytearray and memoryview payloads give the JAX
    package's bytes; truncated (also inside the scan, where libjpeg only
    warns) and corrupt streams raise ValueError in both."""
    request.getfixturevalue(path)
    gray = _encode(np.full((64, 64), 50, np.uint8), mode="L")
    data = _encode(_seeded((60, 44), 7))
    for payload in (gray, _cmyk(), bytearray(data), memoryview(data)):
        np.testing.assert_array_equal(P.decode_resized(payload, 48),
                                      J.decode_resized(payload, 48))
        np.testing.assert_array_equal(P.decode_rgb(payload),
                                      J.decode_rgb(payload))
    P.reset_decode_counts()
    P.decode_resized(_cmyk(), 48)
    assert P.decode_counts()["pil"] == 1  # one arbitration (or PIL decode)
    full = _encode(_smooth(64, 64))
    for bad in (b"\xff\xd8not really a jpeg at all", b"", full[:len(full) // 3],
                full[:int(len(full) * 0.8)]):
        for mod in (P, J):
            with pytest.raises(ValueError):
                mod.decode_resized(bad, 32)
            with pytest.raises(ValueError):
                mod.decode_rgb(bad)


@pytest.mark.parametrize("path", ["native", "pil_only"])
def test_batch_equals_sequential_and_jax(path, request):
    request.getfixturevalue(path)
    datas = [_encode(_seeded((100 + 13 * i, 90 + 7 * i), i))
             for i in range(6)]
    batch = P.decode_batch(datas, 64, threads=3)
    assert batch.shape == (6, 64, 64, 3)
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(batch[i], P.decode_resized(d, 64))
    np.testing.assert_array_equal(batch, J.decode_batch(datas, 64,
                                                        threads=3))
    np.testing.assert_array_equal(P.decode_batch(datas, 64),
                                  P.decode_batch(datas, 64, threads=1))


@pytest.mark.parametrize("path", ["native", "pil_only"])
def test_decode_records_batch_equals_jax(path, request):
    """Mixed records (JPEG, raw, PNG at another size, the TF-official
    keys with a 1-based label, a JPEG padded to exactly S*S*3 bytes,
    which magic makes a JPEG) decode as in the JAX example, batch and
    one by one; the errors are the JAX example's."""
    request.getfixturevalue(path)
    jr = _jax_records()
    size = 24
    raw = np.random.default_rng(3).integers(0, 256, (size, size, 3),
                                            np.uint8)
    small = _encode(raw, quality=20)
    assert len(small) < size * size * 3
    padded = small + b"\0" * (size * size * 3 - len(small))
    recs = [
        {"image": _encode(_seeded((100, 120), 1)), "label": 1},
        {"image": raw.tobytes(), "label": 2},
        {"image": _encode(_seeded((30, 20), 2), fmt="PNG"), "label": 3},
        {"image": _encode(raw, fmt="PNG"), "label": 4},
        {"image/encoded": [_encode(_seeded((90, 70), 3))],
         "image/class/label": [5]},
        {"image": padded, "label": 6},
        {"image": memoryview(_encode(_seeded((33, 44), 4))), "label": 7},
    ]
    got = PR.decode_records_batch(recs, size, threads=2)
    want = jr.decode_records_batch(recs, size)
    assert [lbl for _, lbl in got] == [lbl for _, lbl in want] == \
        [1, 2, 3, 4, 4, 6, 7]
    for (g, _), (w, _), rec in zip(got, want, recs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(PR.decode_record(rec, size)[0], w)
    for bad, err in (([{"image": b"\xff\xd8broken", "label": 0}],
                      ValueError),
                     ([{"label": 0}], KeyError),
                     ([{"image": b"junkbytes", "label": 1}], ValueError)):
        for mod in (PR, jr):
            with pytest.raises(err):
                mod.decode_records_batch(bad, size)


def test_pillow_route_builds_and_equals_jax(native, monkeypatch, tmp_path):
    """The second build route, which the card's host takes (it has no
    system libjpeg): the vendored ABI-62 headers linked against Pillow's
    bundled libjpeg, with an rpath to it; the library passes its
    self-test and decodes the system route's bytes."""
    lib = _build._pillow_libjpeg()
    assert lib is not None and ".so.62" in lib
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_JPEG_PROBE", "#error no system libjpeg\n")
    assert "jpeg" in _build.build(["jpeg"])
    assert _build.jpeg_build_info() == {"route": "pillow", "library": lib}
    pillow = P._bind(ctypes.CDLL(str(tmp_path / _build.LIBS["jpeg"])))
    P._self_test(pillow)
    datas = [_encode(_seeded(s, i)) for i, s in enumerate(SHAPES)]
    want = P.decode_batch(datas, 224)
    monkeypatch.setitem(P._STATE, "lib", pillow)
    np.testing.assert_array_equal(P.decode_batch(datas, 224), want)


def test_failed_self_test_counts_as_not_built(monkeypatch):
    """A library that cannot decode (a header/library mismatch fails
    every ``jpeg_CreateDecompress``) is refused at load, so decodes go
    through PIL visibly instead of arbitrating every image."""

    class Refuses:
        def tfos_jpeg_decode(self, *args):
            return -1

    monkeypatch.setitem(P._STATE, "lib", None)
    monkeypatch.setitem(P._STATE, "tried", False)
    monkeypatch.setitem(P._STATE, "error", None)
    monkeypatch.setattr(P, "_bind", lambda lib: Refuses())
    assert not P.available()
    assert "self-test failed" in P.error()


def test_counts_lose_no_decode_under_many_threads(native):
    """The per-process counters under a pool of more threads than cores
    and a short switch interval: every decode counted once."""
    datas = [_encode(_seeded((40 + i % 7, 30 + i % 5), i)) for i in range(96)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        P.reset_decode_counts()
        P.decode_batch(datas, 16, threads=4 * (os.cpu_count() or 1))
    finally:
        sys.setswitchinterval(old)
    assert P.decode_counts() == {"native": 96, "pil": 0}
