"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source compiles with ``nvcc`` into shared libraries with a plain C
interface under ``build/torch_kernels/`` at the repository root, and
loads through ``ctypes``: seconds per library, where a build that
includes PyTorch's headers takes minutes.  The flash sources
(``FLASH``) build once per instantiation: a library for each head_dim of
``FLASH_HEAD_DIMS`` and each dtype of ``FLASH_DTYPES``, and one a dtype
whose kernels take any head_dim above those that is a multiple of
``FLASH_CHUNK`` (``CHUNKED``), from the same source with
``-DTFOS_HEAD_DIM`` and ``-DTFOS_DTYPE`` (:func:`variant` names them),
so that the builds of one source run in parallel; every other source
builds one library of its own name.  A library is built at
first use and rebuilt when its source, or a shared header
``csrc/*.cuh``, is newer, so the first call on a fresh checkout builds
it.  Nothing here runs at import time.
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

# the flash kernels' instantiations: head_dims (multiples of 16, the
# k-step of mma.sync) and dtypes by the code the C entry points take;
# above the widest, the chunked kernels (head_dim key CHUNKED, built with
# -DTFOS_HEAD_DIM=0) loop over a head_dim that is any multiple of
# FLASH_CHUNK, set at run time
FLASH = ("flash_fwd", "flash_bwd")
FLASH_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
CHUNKED = 0
FLASH_CHUNK = 128
FLASH_DTYPES = {0: "f32", 1: "bf16", 2: "f16"}

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


def variant(source, head_dim, dtype):
    """The library of ``source`` (one of ``FLASH``) built for
    ``head_dim`` (a ``FLASH_HEAD_DIMS`` entry or ``CHUNKED``) and dtype
    code ``dtype``, e.g. ``flash_fwd_d80_bf16``, ``flash_bwd_dchunk_f16``."""
    d = "chunk" if head_dim == CHUNKED else head_dim
    return f"{source}_d{d}_{FLASH_DTYPES[dtype]}"


def _recipes():
    """``{library: (source stem, extra nvcc flags)}`` for every library
    of ``csrc/``, the flash sources' instantiations each their own."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        if path.stem not in FLASH:
            out[path.stem] = (path.stem, ())
            continue
        for d in (*FLASH_HEAD_DIMS, CHUNKED):
            for code in FLASH_DTYPES:
                out[variant(path.stem, d, code)] = (
                    path.stem, (f"-DTFOS_HEAD_DIM={d}",
                                f"-DTFOS_DTYPE={code}"))
    return out


def _recipe(name):
    return _recipes().get(name, (name, ()))


def _lib_path(name):
    return BUILD_DIR / f"lib{name}.so"


def _stale(name):
    """The library is missing, or older than its source or than the
    newest shared header (``csrc/*.cuh``), which every source may
    include."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    source = CSRC / f"{_recipe(name)[0]}.cu"
    newest = max(p.stat().st_mtime for p in [source, *CSRC.glob("*.cuh")])
    return newest > lib.stat().st_mtime


def _start(name):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    source, flags = _recipe(name)
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
           str(CSRC / f"{source}.cu")]
    # the output goes to a file: a pipe nobody reads while several builds
    # run could fill and stall nvcc
    log = tmp.with_suffix(".log").open("w+")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, log, time.perf_counter()


def _finish(name, proc, tmp, log, t0):
    proc.wait()
    build_seconds[name] = time.perf_counter() - t0
    log.seek(0)
    out = build_log[name] = log.read()
    log.close()
    Path(log.name).unlink(missing_ok=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, _lib_path(name))  # atomic: readers never see half a file


def _cost(name):
    """Rank for the build queue: the backward's instantiations first, the
    wide ones first among them (they take longest), the chunked ones
    before every fixed head_dim."""
    source, flags = _recipe(name)
    head_dim = next((int(f.split("=")[1]) for f in flags
                     if f.startswith("-DTFOS_HEAD_DIM=")), None)
    width = (0 if head_dim is None else
             float("inf") if head_dim == CHUNKED else head_dim)
    return (source != "flash_bwd", -width, name)


def build(names=None):
    """Build every stale library in ``names`` (default: all of csrc/'s),
    one ``nvcc`` each, as many at once as the host has cores, the
    longest first.  Returns ``{name: seconds}`` for the libraries it
    built."""
    names = list(_recipes()) if names is None else list(names)
    jobs = os.cpu_count() or 1
    with _LOCK:
        queue = sorted((n for n in names if _stale(n)), key=_cost)
        built, running, errors = [], [], []
        while queue or running:
            while queue and len(running) < jobs:
                n = queue.pop(0)
                running.append((n, *_start(n)))
            done = next((r for r in running if r[1].poll() is not None),
                        None)
            if done is None:
                time.sleep(0.05)
                continue
            running.remove(done)
            try:
                _finish(*done)
                built.append(done[0])
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return {n: build_seconds[n] for n in built}


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
