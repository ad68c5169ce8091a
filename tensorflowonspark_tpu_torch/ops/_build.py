"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface under ``build/torch_kernels/`` at the repository root,
and loads through ``ctypes``: seconds per source, where a build that
includes PyTorch's headers takes minutes.  A library is built at first
use and rebuilt when its source, or a shared header ``csrc/*.cuh``, is
newer, so the first call on a fresh checkout builds it.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS = {}            # name -> ctypes.CDLL
build_seconds = {}    # name -> seconds the last build of ``name`` took
build_log = {}        # name -> nvcc's output (ptxas register/smem report)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _lib_path(name):
    return BUILD_DIR / f"lib{name}.so"


def _stale(name):
    """The library is missing, or older than its source or than the
    newest shared header (``csrc/*.cuh``), which every source may
    include."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime
                 for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return newest > lib.stat().st_mtime


def _start(name):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def _finish(name, proc, tmp, t0):
    out, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = out
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, _lib_path(name))  # atomic: readers never see half a file


def build(names=None):
    """Build every stale source in ``names`` (default: all of csrc/),
    one ``nvcc`` per source, all started together.  Returns
    ``{name: seconds}`` for the sources it built."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    with _LOCK:
        running = [(n, *_start(n)) for n in names if _stale(n)]
        errors = []
        for n, proc, tmp, t0 in running:
            try:
                _finish(n, proc, tmp, t0)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return {n: build_seconds[n] for n, *_ in running}


def load(name):
    """The ``ctypes`` handle of kernel library ``name``, built if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return _LIBS[name]
