"""Build the port's host-native pieces (``native/``) at first use.

Four sources, four libraries under ``build/torch_native/`` at the
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
  to build and the numpy marshal runs instead;
- ``jpegdec.c`` -> ``libtfos_torch_jpeg.so``: the JPEG decoder behind
  ``recordio.jpeg``, built with ``cc`` by the first route that works
  (:func:`_jpeg_route`): (a) the system's ``jpeglib.h`` and ``-ljpeg``,
  when a probe compiles and links; (b) the headers vendored under
  ``native/include/`` (libjpeg-turbo 2.1.5, ABI 62) linked against the
  ABI-62 libjpeg that Pillow's wheel bundles (``pillow.libs/``), with an
  rpath to it.  The route and the library file go into
  ``libtfos_torch_jpeg.json`` beside it (:func:`jpeg_build_info`).
  Without either, ``recordio.jpeg`` decodes through PIL.

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
import glob
import importlib.util
import json
import os
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

NATIVE = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"

SOURCES = {"shmq": "shmqueue.cpp", "marshal": "marshal.c",
           "tfrecord": "tfrecord.cpp", "jpeg": "jpegdec.c"}
LIBS = {"shmq": "libtfos_torch_shmq.so", "marshal": "_tfos_torch_marshal.so",
        "tfrecord": "libtfos_torch_tfrecord.so",
        "jpeg": "libtfos_torch_jpeg.so"}
JPEG_INFO = "libtfos_torch_jpeg.json"

# what jpegdec.c needs of libjpeg, compiled and linked as the probe of
# route (a) (the JAX package's Makefile probes the same way)
_JPEG_PROBE = ("#include <stdio.h>\n#include <jpeglib.h>\n"
               "int main(void){jpeg_std_error(0);return 0;}\n")

_LOCK = threading.Lock()
build_seconds = {}  # name -> seconds its last build in this process took


def lib_path(name):
    return BUILD_DIR / LIBS[name]


def _pillow_libjpeg():
    """The ABI-62 libjpeg that Pillow's wheel bundles, or None.  Only
    ABI 62 matches the vendored headers: another version makes every
    ``jpeg_CreateDecompress`` fail, and every decode would quietly go
    through PIL."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.origin:
        return None
    libs = os.path.join(os.path.dirname(os.path.dirname(spec.origin)),
                        "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, "libjpeg-*.so.62*")))
    return found[0] if found else None


def _jpeg_route(cc):
    """``(compiler arguments after the source, info)`` of the first JPEG
    route that works: (a) the system's libjpeg, (b) the vendored headers
    and Pillow's libjpeg.  Raises RuntimeError when neither does."""
    probe = subprocess.run([cc, "-x", "c", "-", "-ljpeg", "-o", os.devnull],
                           input=_JPEG_PROBE, capture_output=True, text=True)
    if probe.returncode == 0:
        lib = subprocess.run([cc, "-print-file-name=libjpeg.so"],
                             capture_output=True, text=True).stdout.strip()
        return ["-ljpeg"], {"route": "system",
                            "library": os.path.realpath(lib)}
    lib = _pillow_libjpeg()
    if lib is None:
        raise RuntimeError(
            "no libjpeg: the system's does not link (probe: "
            f"{probe.stderr.strip()[-200:]}) and Pillow bundles no ABI-62 "
            "libjpeg (pillow.libs/libjpeg-*.so.62*)")
    return (["-I", str(NATIVE / "include"), lib,
             "-Wl,-rpath," + os.path.dirname(lib)],
            {"route": "pillow", "library": lib})


def jpeg_build_info():
    """``{"route": "system" | "pillow", "library": file}`` of the built
    JPEG library, or None when it is not built."""
    try:
        with open(BUILD_DIR / JPEG_INFO) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _command(name, out):
    src = str(NATIVE / SOURCES[name])
    if name == "jpeg":
        cc = os.environ.get("CC", "cc")
        args, info = _jpeg_route(cc)
        return [cc, "-O3", "-fPIC", "-Wall", "-shared", "-o", str(out),
                src] + args, info
    if name in ("shmq", "tfrecord"):
        cmd = [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
               "-Wall", "-shared", "-o", str(out), src]
        # -lrt: shm_open/shm_unlink live in librt before glibc 2.34
        return (cmd + ["-lrt"] if name == "shmq" else cmd), None
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"no Python.h under {include}: the native "
                           "marshal cannot build (the numpy one runs)")
    # an extension links lazily against the running interpreter
    return [os.environ.get("CC", "cc"), "-O3", "-fPIC", "-Wall", "-shared",
            "-I", include, "-o", str(out), src], None


def _stale(name):
    lib = lib_path(name)
    return (not lib.exists()
            or (NATIVE / SOURCES[name]).stat().st_mtime
            > lib.stat().st_mtime)


def build(names=None):
    """Build every stale library of ``names`` (default: all four), one
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
                t0 = time.perf_counter()
                try:
                    cmd, info = _command(name, tmp)
                    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)
                except (OSError, RuntimeError) as e:
                    errors.append(f"{SOURCES[name]}: {e}")
                    continue
                running.append((name, proc, tmp, t0, info))
            built = {}
            for name, proc, tmp, t0, info in running:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    errors.append(f"{SOURCES[name]} (exit {proc.returncode})"
                                  f":\n{out}")
                    continue
                if info is not None:  # the JPEG route, beside its library
                    with open(BUILD_DIR / f".{JPEG_INFO}.tmp", "w") as f:
                        json.dump(info, f)
                    os.replace(BUILD_DIR / f".{JPEG_INFO}.tmp",
                               BUILD_DIR / JPEG_INFO)
                os.replace(tmp, lib_path(name))
                built[name] = build_seconds[name] = \
                    time.perf_counter() - t0
            if errors:
                raise RuntimeError("native build failed: "
                                   + "\n".join(errors))
            return built

