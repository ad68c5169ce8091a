"""ctypes binding of the port's shared-memory ring (``native/shmqueue.cpp``).

Loads ``build/torch_native/libtfos_torch_shmq.so``, building it first
when it is missing or stale (``recordio._build``).  Only the port's own
build is a candidate: the port never loads a library of the JAX package
or of ``native/``.  ``load()`` returns None when the library cannot be
built or loaded; the feed then stays on the manager queue.
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
                _build.build(["shmq"])
                _STATE["lib"] = _bind(ctypes.CDLL(str(_build.lib_path(
                    "shmq"))))
            except (OSError, RuntimeError) as e:
                _STATE["error"] = str(e)
                logger.warning("shm ring unavailable: %s", e)
            _STATE["tried"] = True
    return _STATE["lib"]


def error():
    """Why ``load()`` returned None, or None."""
    return _STATE["error"]


def _bind(lib):
    c = ctypes
    lib.shq_create.restype = c.c_void_p
    lib.shq_create.argtypes = [c.c_char_p, c.c_uint64]
    lib.shq_open.restype = c.c_void_p
    lib.shq_open.argtypes = [c.c_char_p, c.c_int]
    lib.shq_push.restype = c.c_int
    lib.shq_push.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64, c.c_int]
    lib.shq_push_iov.restype = c.c_int
    lib.shq_push_iov.argtypes = [c.c_void_p, c.POINTER(c.c_void_p),
                                 c.POINTER(c.c_uint64), c.c_int, c.c_int]
    lib.shq_peek_len.restype = c.c_int64
    lib.shq_peek_len.argtypes = [c.c_void_p, c.c_int]
    lib.shq_pop_into.restype = c.c_int64
    lib.shq_pop_into.argtypes = [c.c_void_p, c.c_void_p]
    lib.shq_pop.restype = c.c_int64
    lib.shq_pop.argtypes = [c.c_void_p, c.c_int]
    lib.shq_buffer.restype = c.POINTER(c.c_uint8)
    lib.shq_buffer.argtypes = [c.c_void_p]
    lib.shq_close_write.restype = None
    lib.shq_close_write.argtypes = [c.c_void_p]
    lib.shq_size.restype = c.c_uint64
    lib.shq_size.argtypes = [c.c_void_p]
    lib.shq_free.restype = None
    lib.shq_free.argtypes = [c.c_void_p]
    return lib
