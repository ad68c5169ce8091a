"""JPEG decode for the host input path: ctypes over the port's
``native/jpegdec.c``, with PIL behind it.

The port's own copy of ``tensorflowonspark_tpu/recordio/jpeg.py``, with
the same results byte for byte.  The library is built at first use
(``recordio._build``: the system's libjpeg, else the vendored headers
and the libjpeg that Pillow bundles) and must decode one seeded JPEG
after it loads, or it counts as not built.  Two things make it faster
than PIL:

- the C call releases the GIL (ctypes), so ``decode_batch`` scales
  across a thread pool instead of serialising on the interpreter;
- libjpeg's DCT scaling decodes at 1/2, 1/4 or 1/8 of the size when a
  target size is given, so most of an ImageNet-sized image is never
  decoded at full resolution.

The native decoder is strict: whatever it refuses (CMYK, a stream that
makes libjpeg warn, such as a truncated one) is arbitrated through PIL,
so a valid but odd image decodes and corrupt data raises ValueError.
``TFOS_NO_NATIVE=1`` sends every decode through PIL.
``decode_counts()`` says how many decodes of this process the native
library did and how many went through PIL (observability only).
"""

from __future__ import annotations

import ctypes
import io
import logging
import os
import threading

import numpy as np

from tensorflowonspark_tpu_torch.recordio import _build

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
_STATE = {"lib": None, "tried": False, "error": None}
_COUNTS_LOCK = threading.Lock()
_COUNTS = {"native": 0, "pil": 0}


def _load():
    """The bound library, built and self-tested if needed; None where it
    is unavailable (the reason is in ``error()``) or where
    ``TFOS_NO_NATIVE=1``."""
    if _STATE["tried"]:
        return _STATE["lib"]
    with _LOCK:
        if not _STATE["tried"]:
            if os.environ.get("TFOS_NO_NATIVE") == "1":
                _STATE["error"] = "TFOS_NO_NATIVE=1"
            else:
                try:
                    _build.build(["jpeg"])
                    lib = _bind(ctypes.CDLL(str(_build.lib_path("jpeg"))))
                    _self_test(lib)
                    _STATE["lib"] = lib
                except (OSError, RuntimeError, ImportError) as e:
                    _STATE["error"] = str(e)
                    logger.warning("native JPEG decoder unavailable, PIL "
                                   "decodes: %s", e)
            _STATE["tried"] = True
    return _STATE["lib"]


def _bind(lib):
    c = ctypes
    lib.tfos_jpeg_decode.restype = c.c_int
    lib.tfos_jpeg_decode.argtypes = [
        c.c_char_p, c.c_size_t, c.c_int, c.c_void_p, c.c_size_t,
        c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.tfos_jpeg_info.restype = c.c_int
    lib.tfos_jpeg_info.argtypes = [
        c.c_char_p, c.c_size_t, c.c_int,
        c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.tfos_jpeg_decode_resized.restype = c.c_int
    lib.tfos_jpeg_decode_resized.argtypes = [
        c.c_char_p, c.c_size_t, c.c_int, c.c_void_p, c.c_size_t, c.c_void_p]
    return lib


def _self_test(lib):
    """Decode one seeded 40x56 JPEG natively; raise RuntimeError unless
    it decodes (a header/library mismatch fails every
    ``jpeg_CreateDecompress``, which would otherwise send every decode
    quietly through PIL)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(
        buf, "JPEG", quality=90)
    data = buf.getvalue()
    out = np.empty((40, 56, 3), np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.tfos_jpeg_decode(data, len(data), 0,
                              out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
                              ctypes.byref(w), ctypes.byref(h))
    if rc != 0 or (h.value, w.value) != (40, 56):
        raise RuntimeError(
            f"native JPEG self-test failed (rc {rc}, {w.value}x{h.value}; "
            f"libjpeg {_build.jpeg_build_info()})")


def available():
    return _load() is not None


def error():
    """Why ``available()`` is false, or None."""
    return _STATE["error"]


def decode_counts():
    """``{"native": n, "pil": n}``: this process's decodes by the native
    library and through PIL (every PIL decode is an arbitration where
    the library is loaded)."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_decode_counts():
    with _COUNTS_LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


def _count(kind):
    with _COUNTS_LOCK:
        _COUNTS[kind] += 1


def _pil_decode(data):
    from PIL import Image

    _count("pil")
    try:
        img = Image.open(io.BytesIO(data)).convert("RGB")
        return np.asarray(img, np.uint8)
    except Exception as e:  # noqa: BLE001 - normalise PIL's error zoo
        raise ValueError(f"not a decodable JPEG ({e})") from None


def decode_rgb(data, target_min=0):
    """JPEG bytes -> RGB uint8 [h, w, 3].  ``target_min > 0`` allows a
    DCT-scaled decode whose min(h, w) is still >= target_min (the exact
    final size is the caller's).  Raises ValueError on corrupt input;
    what the strict native decoder refuses retries through PIL."""
    lib = _load()
    if lib is None:
        return _pil_decode(data)
    if not isinstance(data, bytes):
        data = bytes(data)  # ctypes c_char_p takes bytes only
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.tfos_jpeg_info(data, len(data), int(target_min),
                          ctypes.byref(w), ctypes.byref(h)) != 0:
        return _pil_decode(data)
    out = np.empty((h.value, w.value, 3), np.uint8)  # the scaled size
    rc = lib.tfos_jpeg_decode(
        data, len(data), int(target_min),
        out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
        ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return _pil_decode(data)
    _count("native")
    if (h.value, w.value) != out.shape[:2]:
        out = out.reshape(-1)[: h.value * w.value * 3]
        out = out.reshape(h.value, w.value, 3)
    return out


def _resize_bilinear(img, size):
    """uint8 [h, w, c] -> [size, size, c], half-pixel-centre bilinear
    (PIL's sampling convention), in numpy: the C resize's arithmetic."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img
    ys = (np.arange(size, dtype=np.float32) + 0.5) * (h / size) - 0.5
    xs = (np.arange(size, dtype=np.float32) + 0.5) * (w / size) - 0.5
    ys = np.clip(ys, 0, h - 1)
    xs = np.clip(xs, 0, w - 1)
    y0 = np.minimum(ys.astype(np.int32), h - 2) if h > 1 else \
        np.zeros(size, np.int32)
    x0 = np.minimum(xs.astype(np.int32), w - 2) if w > 1 else \
        np.zeros(size, np.int32)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    f = img.astype(np.float32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return np.clip(top * (1 - wy) + bot * wy + 0.5, 0, 255).astype(np.uint8)


def decode_resized(data, size, _out=None):
    """JPEG bytes -> RGB uint8 [size, size, 3] (bilinear).  Native: the
    DCT-scaled decode and the C resize in one GIL-free call; else PIL's
    decode and the numpy bilinear."""
    lib = _load()
    if lib is None:
        return _resize_bilinear(_pil_decode(data), size)
    if not isinstance(data, bytes):
        data = bytes(data)  # ctypes c_char_p takes bytes only
    w = ctypes.c_int()
    h = ctypes.c_int()
    out = _out if _out is not None else np.empty((size, size, 3), np.uint8)
    if lib.tfos_jpeg_info(data, len(data), size,
                          ctypes.byref(w), ctypes.byref(h)) != 0:
        out[...] = _resize_bilinear(_pil_decode(data), size)
        return out
    scratch = np.empty((h.value, w.value, 3), np.uint8)  # DCT-scaled size
    rc = lib.tfos_jpeg_decode_resized(
        data, len(data), size,
        scratch.ctypes.data_as(ctypes.c_void_p), scratch.nbytes,
        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        # the strict decoder refused (a warning, truncation, CMYK): PIL
        # arbitrates, so a valid but odd image decodes and a corrupt one
        # raises
        out[...] = _resize_bilinear(_pil_decode(data), size)
    else:
        _count("native")
    return out


def default_threads():
    """``decode_batch``'s thread count when none is given."""
    return min(8, os.cpu_count() or 1)


def decode_batch(datas, size, threads=None):
    """Decode many JPEGs at once -> uint8 [n, size, size, 3], each row
    decoded into its place in one preallocated array.

    The native decode and resize release the GIL for their whole call,
    so a thread pool scales with cores; the PIL path stays sequential
    (its threads would serialise on the interpreter).  The pool's
    threads have all ended when this returns."""
    n = len(datas)
    out = np.empty((n, size, size, 3), np.uint8)
    if _load() is None or n <= 1:
        for i, d in enumerate(datas):
            out[i] = decode_resized(d, size)
        return out
    from concurrent.futures import ThreadPoolExecutor

    def work(i):
        decode_resized(datas[i], size, _out=out[i])

    with ThreadPoolExecutor(max_workers=threads or default_threads()) as pool:
        list(pool.map(work, range(n)))
    return out
