"""Build the port's host-native pieces (``native/``) at first use.

Three sources, three libraries under ``build/torch_native/`` at the
repository root:

- ``shmqueue.cpp`` -> ``libtfos_torch_shmq.so``: the shared-memory feed
  ring, a plain C interface loaded with ``ctypes`` (``recordio.native``),
  built with ``g++ -O3 -fPIC -std=c++17 -shared ... -lrt``;
- ``tfrecord.cpp`` -> ``libtfos_torch_tfrecord.so``: TFRecord framing,
  the ``tf.train.Example`` codec and the columnar bulk loader, a plain C
  interface loaded with ``ctypes`` (``recordio.tfrecord_native``), built
  with ``g++ -O3 -fPIC -std=c++17 -shared``;
- ``marshal.c`` -> ``_tfos_torch_marshal.so``: the CPython extension
  behind ``recordio.marshal``, built with ``cc`` against the running
  interpreter's headers (``sysconfig``).  Without ``Python.h`` it fails
  to build and the numpy marshal runs instead.

A library is built when it is missing or older than its source.
Executors, the trainers they fork and parallel test workers are separate
processes that may all ask at once on a fresh checkout, so the check and
the build run under an exclusive ``fcntl.flock`` on
``build/torch_native/.lock``; a process that waited finds the library
built.  Outputs are written to a temporary name and renamed into place,
so no process loads half a file.  Nothing here runs at import time.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

NATIVE = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"

SOURCES = {"shmq": "shmqueue.cpp", "marshal": "marshal.c",
           "tfrecord": "tfrecord.cpp"}
LIBS = {"shmq": "libtfos_torch_shmq.so", "marshal": "_tfos_torch_marshal.so",
        "tfrecord": "libtfos_torch_tfrecord.so"}

_LOCK = threading.Lock()
build_seconds = {}  # name -> seconds its last build in this process took


def lib_path(name):
    return BUILD_DIR / LIBS[name]


def _command(name, out):
    src = str(NATIVE / SOURCES[name])
    if name in ("shmq", "tfrecord"):
        cmd = [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
               "-Wall", "-shared", "-o", str(out), src]
        # -lrt: shm_open/shm_unlink live in librt before glibc 2.34
        return cmd + ["-lrt"] if name == "shmq" else cmd
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"no Python.h under {include}: the native "
                           "marshal cannot build (the numpy one runs)")
    # an extension links lazily against the running interpreter
    return [os.environ.get("CC", "cc"), "-O3", "-fPIC", "-Wall", "-shared",
            "-I", include, "-o", str(out), src]


def _stale(name):
    lib = lib_path(name)
    return (not lib.exists()
            or (NATIVE / SOURCES[name]).stat().st_mtime
            > lib.stat().st_mtime)


def build(names=None):
    """Build every stale library of ``names`` (default: all three), one
    compiler per source, started together.  Returns ``{name: seconds}``
    for those it built; raises RuntimeError naming each that failed."""
    names = sorted(SOURCES) if names is None else list(names)
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            running, errors = [], []
            for name in names:
                if not _stale(name):
                    continue
                tmp = BUILD_DIR / f".{LIBS[name]}.{os.getpid()}.tmp"
                try:
                    cmd = _command(name, tmp)
                    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)
                except (OSError, RuntimeError) as e:
                    errors.append(f"{SOURCES[name]}: {e}")
                    continue
                running.append((name, proc, tmp, time.perf_counter()))
            built = {}
            for name, proc, tmp, t0 in running:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    errors.append(f"{SOURCES[name]} (exit {proc.returncode})"
                                  f":\n{out}")
                    continue
                os.replace(tmp, lib_path(name))
                built[name] = build_seconds[name] = \
                    time.perf_counter() - t0
            if errors:
                raise RuntimeError("native build failed: "
                                   + "\n".join(errors))
            return built

