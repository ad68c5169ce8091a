"""Shared epoch cache: one materialisation of a pipeline's epoch, many
readers.

An own copy of ``tensorflowonspark_tpu/data/cache.py``.  Consumers of
the same pipeline epoch (dynamic-split data workers serving several
trainers, epochs replayed) pay the read and transform once; the rest
read blocks from memory, or from the spill file, at replay speed.

- :class:`EpochCache`: an incremental block store over one pipeline.
  ``block(i)`` drives the one underlying iterator just far enough to
  have block ``i``, so split serving (``blocks_range(k*B, B)``) never
  recomputes a prefix and needs no complete first pass, as
  ``Pipeline.cache()`` does.  Thread-safe; blocks past ``memory_bytes``
  spill to one pickle file with an offset a block (seek, not scan).
- a registry for the process, keyed by :meth:`Pipeline.signature`:
  ``shared(pipeline)`` returns the cache for that content, so consumers
  that never see each other's objects share one materialisation.  Its
  scope is one process: workers in other executors hold their own.

Metrics: ``tfos_data_cache_hits_total`` and ``_misses_total`` (registry
lookups), ``tfos_data_cache_blocks`` and ``_bytes`` (gauges),
``tfos_data_cache_spilled_total``.
"""

from __future__ import annotations

import logging
import os
import pickle
import tempfile
import threading
import weakref

from tensorflowonspark_tpu_torch.utils import metrics_registry

logger = logging.getLogger(__name__)

CACHE_MB_ENV = "TFOS_DATA_CACHE_MB"
CACHE_DIR_ENV = "TFOS_DATA_CACHE_DIR"


def default_memory_bytes():
    """Memory budget for one epoch cache: ``TFOS_DATA_CACHE_MB`` (256)."""
    try:
        return max(1, int(os.environ.get(CACHE_MB_ENV, "256"))) << 20
    except ValueError:
        return 256 << 20


class EpochCache:
    """Incrementally materialized epoch of one pipeline (see module
    docstring).  ``block(i)`` returns block ``i`` or None past the end;
    ``num_blocks`` is known once the end was reached."""

    def __init__(self, pipeline, memory_bytes=None, spill_dir=None):
        self.signature = pipeline.signature()
        self.memory_bytes = (default_memory_bytes()
                             if memory_bytes is None else int(memory_bytes))
        self.spill_dir = spill_dir or os.environ.get(CACHE_DIR_ENV) or None
        self._lock = threading.RLock()
        self._it = pipeline._iter()  # THE single fill iterator
        self._mem = []               # blocks resident in memory
        self._mem_bytes = 0
        self._spill_f = None         # append handle while filling
        self._spill_path = None
        self._spill_offsets = []     # byte offset per spilled block
        self._count = 0              # blocks materialized so far
        self._eof = None             # total block count once known
        self._finalizer = None

    # -- size accounting ---------------------------------------------------

    @staticmethod
    def _block_bytes(block):
        import numpy as np

        total = 0
        for col in block.values():
            if isinstance(col, np.ndarray):
                total += col.nbytes
            else:
                total += sum(len(v) if isinstance(v, (bytes, str)) else 64
                             for v in col)
        return total

    # -- fill --------------------------------------------------------------

    def _fill_to(self, i):
        """Advance the fill iterator until block ``i`` exists or EOF.
        Caller holds the lock."""
        while self._eof is None and self._count <= i:
            block = next(self._it, None)
            if block is None:
                self._eof = self._count
                if self._spill_f is not None:
                    self._spill_f.flush()
                break
            self._store(block)

    def _store(self, block):
        nbytes = self._block_bytes(block)
        if self._spill_f is None \
                and self._mem_bytes + nbytes <= self.memory_bytes:
            self._mem.append(block)
            self._mem_bytes += nbytes
        else:
            if self._spill_f is None:
                fd, self._spill_path = tempfile.mkstemp(
                    prefix="tfos-epoch-cache-", suffix=".pkl",
                    dir=self.spill_dir)
                self._spill_f = os.fdopen(fd, "wb")
                self._finalizer = weakref.finalize(
                    self, _unlink_quiet, self._spill_path)
            self._spill_offsets.append(self._spill_f.tell())
            pickle.dump(block, self._spill_f,
                        protocol=pickle.HIGHEST_PROTOCOL)
            metrics_registry.inc("tfos_data_cache_spilled_total")
        self._count += 1
        if metrics_registry.enabled():
            metrics_registry.set_gauge("tfos_data_cache_blocks",
                                       self._count)
            metrics_registry.set_gauge("tfos_data_cache_bytes",
                                       self._mem_bytes)

    # -- read --------------------------------------------------------------

    def block(self, i):
        """Block ``i`` (filling the cache up to it), or None past EOF."""
        with self._lock:
            if self._eof is None and i >= self._count:
                self._fill_to(i)
            if self._eof is not None and i >= self._eof:
                return None
            if i < len(self._mem):
                return self._mem[i]
            j = i - len(self._mem)
            self._spill_f.flush()
            offset = self._spill_offsets[j]
        # read outside the lock: offsets are append-only and the block
        # at a recorded offset is fully written (flushed above)
        with open(self._spill_path, "rb") as f:
            f.seek(offset)
            return pickle.load(f)

    def blocks_range(self, skip_blocks=0, num_blocks=None):
        """Iterate blocks [skip, skip+num) — the split-serving read."""
        i = skip_blocks
        served = 0
        while num_blocks is None or served < num_blocks:
            block = self.block(i)
            if block is None:
                return
            yield block
            i += 1
            served += 1

    @property
    def num_blocks(self):
        """Total block count, or None while the end is undiscovered."""
        return self._eof

    def close(self):
        with self._lock:
            if self._spill_f is not None:
                try:
                    self._spill_f.close()
                except OSError:
                    pass
                self._spill_f = None
            if self._finalizer is not None:
                self._finalizer()
                self._finalizer = None
            self._mem = []
            self._spill_offsets = []


def _unlink_quiet(path):
    try:
        os.unlink(path)
    except OSError:
        pass


# --------------------------------------------------------------------------
# process-wide registry


_registry = {}
_registry_lock = threading.Lock()


def shared(pipeline, memory_bytes=None, spill_dir=None):
    """THE :class:`EpochCache` for this pipeline's content signature in
    this process — created on first call (a miss), returned to every
    later caller with an equal-signature pipeline (hits)."""
    sig = pipeline.signature()
    with _registry_lock:
        cache = _registry.get(sig)
        if cache is not None:
            metrics_registry.inc("tfos_data_cache_hits_total")
            return cache
        metrics_registry.inc("tfos_data_cache_misses_total")
        cache = EpochCache(pipeline, memory_bytes=memory_bytes,
                           spill_dir=spill_dir)
        _registry[sig] = cache
        return cache


def drop(signature):
    """Evict one cache from the registry (tests / explicit refresh)."""
    with _registry_lock:
        cache = _registry.pop(signature, None)
    if cache is not None:
        cache.close()


def clear():
    """Evict every cache (tests)."""
    with _registry_lock:
        caches = list(_registry.values())
        _registry.clear()
    for c in caches:
        c.close()
