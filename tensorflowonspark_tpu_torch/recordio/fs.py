"""Filesystem routing for record IO and checkpoints: plain local paths
go to the OS, every other scheme through fsspec.

The port's own copy of ``tensorflowonspark_tpu/recordio/fs.py``.  A
plain path or a ``file://`` URL is a local path and stays on ``open`` /
``os`` (and, for TFRecords, the C library's ``fopen``-based reader and
writer); a remote URL (``gs://``, ``hdfs://``, ``s3://``,
``memory://``, ...) goes through ``fsspec``, imported at first use.
Which remote schemes work depends on the fsspec backends installed
(``memory://`` always does; ``gs://`` needs ``gcsfs``).
"""

from __future__ import annotations

import os
import re

_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")


def scheme_of(path) -> str | None:
    """URL scheme of a path, or None for plain local paths."""
    m = _SCHEME_RE.match(str(path))
    return m.group(1).lower() if m else None


def is_local(path) -> bool:
    s = scheme_of(path)
    return s is None or s in ("file", "local")


def local_path(path) -> str:
    """Strip a ``file://`` prefix down to an OS path (the JAX package's
    ``hdfs_path`` 'file://' row); any other path is returned as it is."""
    p = str(path)
    s = scheme_of(p)
    if s in ("file", "local"):
        return p[len(s) + 3:] or "/"
    return p


def get_fs(path):
    """(fsspec filesystem, path within it) for any URL."""
    import fsspec

    return fsspec.core.url_to_fs(str(path))


def open_file(path, mode="rb"):
    """Local paths through ``open``; remote ones through fsspec."""
    if is_local(path):
        return open(local_path(path), mode)
    fs, p = get_fs(path)
    return fs.open(p, mode)


def read_bytes(path) -> bytes:
    with open_file(path, "rb") as f:
        return f.read()


def write_bytes(path, data: bytes):
    with open_file(path, "wb") as f:
        f.write(data)


def makedirs(path):
    if is_local(path):
        os.makedirs(local_path(path), exist_ok=True)
    else:
        fs, p = get_fs(path)
        fs.makedirs(p, exist_ok=True)


def isdir(path) -> bool:
    if is_local(path):
        return os.path.isdir(local_path(path))
    fs, p = get_fs(path)
    return fs.isdir(p)


def exists(path) -> bool:
    if is_local(path):
        return os.path.exists(local_path(path))
    fs, p = get_fs(path)
    return fs.exists(p)


def remove(path):
    if is_local(path):
        os.remove(local_path(path))
    else:
        fs, p = get_fs(path)
        fs.rm(p)


def listdir(path):
    """Names (not full paths) of a directory's entries."""
    if is_local(path):
        return os.listdir(local_path(path))
    fs, p = get_fs(path)
    return [name.rstrip("/").rsplit("/", 1)[-1]
            for name in fs.ls(p, detail=False)]


def join(path, *parts) -> str:
    """Join that keeps the URL scheme (``os.path.join`` would not), with
    slashes stripped at the seams as the JAX package's, so both packages
    name shards and checkpoints alike."""
    base = str(path).rstrip("/")
    tail = "/".join(str(p).strip("/") for p in parts)
    return f"{base}/{tail}" if tail else base
