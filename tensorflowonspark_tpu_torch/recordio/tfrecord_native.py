"""ctypes binding of the port's TFRecord library (``native/tfrecord.cpp``).

Loads ``build/torch_native/libtfos_torch_tfrecord.so``, building it
first when it is missing or stale (``recordio._build``).  Only the
port's own build is a candidate: the port never loads a library of the
JAX package or of the top-level ``native/``.  ``load()`` returns None
when the library cannot be built or loaded; ``recordio`` then reads and
writes through the pure-Python codec (``pyimpl``), with the same
results.
"""

from __future__ import annotations

import ctypes
import logging
import threading

from tensorflowonspark_tpu_torch.recordio import _build

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
_STATE = {"lib": None, "tried": False, "error": None}


def load():
    """The bound library, built if needed; None if unavailable (the
    reason is in ``error()``)."""
    if _STATE["tried"]:
        return _STATE["lib"]
    with _LOCK:
        if not _STATE["tried"]:
            try:
                _build.build(["tfrecord"])
                _STATE["lib"] = _bind(ctypes.CDLL(str(_build.lib_path(
                    "tfrecord"))))
            except (OSError, RuntimeError) as e:
                _STATE["error"] = str(e)
                logger.warning("native TFRecord codec unavailable, the "
                               "Python codec runs: %s", e)
            _STATE["tried"] = True
    return _STATE["lib"]


def error():
    """Why ``load()`` returned None, or None."""
    return _STATE["error"]


def _bind(lib):
    c = ctypes
    u8p = c.POINTER(c.c_uint8)

    lib.tfr_writer_open.restype = c.c_void_p
    lib.tfr_writer_open.argtypes = [c.c_char_p]
    lib.tfr_writer_write.restype = c.c_int
    lib.tfr_writer_write.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib.tfr_writer_close.restype = c.c_int
    lib.tfr_writer_close.argtypes = [c.c_void_p]

    lib.tfr_reader_open.restype = c.c_void_p
    lib.tfr_reader_open.argtypes = [c.c_char_p]
    lib.tfr_reader_next.restype = c.c_int64
    lib.tfr_reader_next.argtypes = [c.c_void_p, c.POINTER(u8p)]
    lib.tfr_reader_close.restype = c.c_int
    lib.tfr_reader_close.argtypes = [c.c_void_p]

    lib.exb_new.restype = c.c_void_p
    lib.exb_new.argtypes = []
    lib.exb_free.restype = None
    lib.exb_free.argtypes = [c.c_void_p]
    for fn, val in (("exb_add_int64", c.c_int64), ("exb_add_float",
                                                    c.c_float)):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [c.c_void_p, c.c_char_p,
                                     c.POINTER(val), c.c_int]
    lib.exb_add_bytes.restype = None
    lib.exb_add_bytes.argtypes = [c.c_void_p, c.c_char_p,
                                  c.POINTER(c.c_char_p),
                                  c.POINTER(c.c_uint64), c.c_int]
    lib.exb_serialize.restype = u8p
    lib.exb_serialize.argtypes = [c.c_void_p, c.POINTER(c.c_uint64)]

    lib.exd_parse.restype = c.c_void_p
    lib.exd_parse.argtypes = [c.c_char_p, c.c_uint64]
    lib.exd_free.restype = None
    lib.exd_free.argtypes = [c.c_void_p]
    lib.exd_num_features.restype = c.c_int
    lib.exd_num_features.argtypes = [c.c_void_p]
    lib.exd_name.restype = c.c_char_p
    lib.exd_name.argtypes = [c.c_void_p, c.c_int]
    lib.exd_kind.restype = c.c_int
    lib.exd_kind.argtypes = [c.c_void_p, c.c_int]
    lib.exd_value_count.restype = c.c_int64
    lib.exd_value_count.argtypes = [c.c_void_p, c.c_int]
    lib.exd_floats.restype = c.POINTER(c.c_float)
    lib.exd_floats.argtypes = [c.c_void_p, c.c_int]
    lib.exd_int64s.restype = c.POINTER(c.c_int64)
    lib.exd_int64s.argtypes = [c.c_void_p, c.c_int]
    lib.exd_bytes.restype = u8p
    lib.exd_bytes.argtypes = [c.c_void_p, c.c_int, c.c_int,
                              c.POINTER(c.c_uint64)]

    # the memory-buffer framing of remote paths (fsspec moves the bytes)
    lib.tfr_mem_writer_new.restype = c.c_void_p
    lib.tfr_mem_writer_new.argtypes = []
    lib.tfr_mem_writer_write.restype = c.c_int
    lib.tfr_mem_writer_write.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib.tfr_mem_writer_data.restype = u8p
    lib.tfr_mem_writer_data.argtypes = [c.c_void_p, c.POINTER(c.c_uint64)]
    lib.tfr_mem_writer_clear.restype = None
    lib.tfr_mem_writer_clear.argtypes = [c.c_void_p]
    lib.tfr_mem_writer_free.restype = None
    lib.tfr_mem_writer_free.argtypes = [c.c_void_p]
    lib.tfr_mem_reader_new.restype = c.c_void_p
    lib.tfr_mem_reader_new.argtypes = [c.c_char_p, c.c_uint64]
    lib.tfr_mem_reader_next.restype = c.c_int64
    lib.tfr_mem_reader_next.argtypes = [c.c_void_p, c.POINTER(u8p)]
    lib.tfr_mem_reader_free.restype = None
    lib.tfr_mem_reader_free.argtypes = [c.c_void_p]

    lib.tfr_load_columnar.restype = c.c_void_p
    lib.tfr_load_columnar.argtypes = [c.c_char_p]
    lib.tfr_load_columnar_mem.restype = c.c_void_p
    lib.tfr_load_columnar_mem.argtypes = [c.c_char_p, c.c_uint64]
    lib.colb_ok.restype = c.c_int
    lib.colb_ok.argtypes = [c.c_void_p]
    lib.colb_error.restype = c.c_char_p
    lib.colb_error.argtypes = [c.c_void_p]
    lib.colb_num_rows.restype = c.c_int64
    lib.colb_num_rows.argtypes = [c.c_void_p]
    lib.colb_num_features.restype = c.c_int
    lib.colb_num_features.argtypes = [c.c_void_p]
    lib.colb_name.restype = c.c_char_p
    lib.colb_name.argtypes = [c.c_void_p, c.c_int]
    lib.colb_kind.restype = c.c_int
    lib.colb_kind.argtypes = [c.c_void_p, c.c_int]
    lib.colb_width.restype = c.c_int64
    lib.colb_width.argtypes = [c.c_void_p, c.c_int]
    lib.colb_floats.restype = c.POINTER(c.c_float)
    lib.colb_floats.argtypes = [c.c_void_p, c.c_int]
    lib.colb_int64s.restype = c.POINTER(c.c_int64)
    lib.colb_int64s.argtypes = [c.c_void_p, c.c_int]
    lib.colb_bytes_blob.restype = u8p
    lib.colb_bytes_blob.argtypes = [c.c_void_p, c.c_int]
    lib.colb_bytes_offsets.restype = c.POINTER(c.c_uint64)
    lib.colb_bytes_offsets.argtypes = [c.c_void_p, c.c_int]
    lib.colb_free.restype = None
    lib.colb_free.argtypes = [c.c_void_p]

    lib.tfr_crc32c.restype = c.c_uint32
    lib.tfr_crc32c.argtypes = [c.c_char_p, c.c_uint64]
    return lib
