"""Filesystem routing for record IO and checkpoints: local paths only.

The port's own copy of ``tensorflowonspark_tpu/recordio/fs.py`` without
its fsspec routes.  A plain path or a ``file://`` URL is a local path;
any other scheme (``gs://``, ``hdfs://``, ``s3://``, ``memory://``, ...)
raises NotImplementedError naming the ROADMAP item that brings remote
paths.
"""

from __future__ import annotations

import os
import re

REMOTE_ITEM = "ROADMAP.md queue 1, item 9 (remote paths)"

_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")


def scheme_of(path) -> str | None:
    """URL scheme of a path, or None for plain local paths."""
    m = _SCHEME_RE.match(str(path))
    return m.group(1).lower() if m else None


def local_path(path) -> str:
    """The OS path of a local path or ``file://`` URL (the JAX package's
    ``hdfs_path`` 'file://' row); raises NotImplementedError for any
    other scheme."""
    p = str(path)
    s = scheme_of(p)
    if s is None:
        return p
    if s in ("file", "local"):
        return p[len(s) + 3:] or "/"
    raise NotImplementedError(f"paths on {s}:// come with {REMOTE_ITEM}")


def makedirs(path):
    os.makedirs(local_path(path), exist_ok=True)


def isdir(path) -> bool:
    return os.path.isdir(local_path(path))


def listdir(path):
    """Names (not full paths) of a directory's entries."""
    return os.listdir(local_path(path))


def join(path, *parts) -> str:
    """The JAX package's join (slashes stripped at the seams), so both
    packages name shards alike."""
    base = str(path).rstrip("/")
    tail = "/".join(str(p).strip("/") for p in parts)
    return f"{base}/{tail}" if tail else base
